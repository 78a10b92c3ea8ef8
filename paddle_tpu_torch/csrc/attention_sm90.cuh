// The Hopper attention-forward mainloop, for sm_90a, shared by
// flash_attention.cu (K/V contiguous, [B, Sk, KH, D]) and paged_attention.cu
// (K/V in 16-token blocks of the KV pool, [NB, 16, KH, D], found through a
// block table).  Both compute, for a 64-vector query tile, softmax(Q K^T *
// scale) V with an f32 online softmax over K/V tiles of 64 keys walked in
// order from key 0; they differ only in where a K/V tile comes from.
//
// Work split.  A thread block (CTA) owns NC (1 or 2) query tiles of 64
// vectors, one per consumer warpgroup (warps 0 .. 4 NC - 1), and one
// producer warpgroup (the last four warps) whose first warp keeps K/V tiles
// in flight into a ring of ST shared-memory stages with TMA.  Each stage has
// a "full" mbarrier (the producer's expected bytes, completed by TMA) and an
// "empty" one (one arrival per consumer warp once its wgmma reads of the
// stage are done).  setmaxnreg moves registers from the producer to the
// consumers.  Every consumer warpgroup waits on every tile the CTA loads and
// computes only the tiles its own rows can see, so the two warpgroups of a
// causal CTA each stop at their own diagonal.  Warp and warpgroup indices
// are broadcast from lane 0 so the compiler sees the role branch as
// uniform: a wgmma on a path it thinks divergent is serialised.
//
// Math.  S = Q K^T is wgmma m64n64k16 with both operands in shared memory
// (K-major); the scores stay in f32 registers and are scaled into log2
// units by one multiply (scale * log2 e).  The running max m has the finite
// floor NEG_INF, masked probabilities are a literal 0 (never
// exp2(NEG_INF - m)), and O is divided by l once, in the epilogue.  The
// softmax is branch-free (a tile that every row sees whole skips the mask
// arithmetic through one uniform branch), takes exp2 as one ex2.approx.ftz
// and reduces a row's 16 values per thread in one fixed pairwise order.
// O += P V is wgmma m64nDPk16 with P from registers and V from shared
// memory read transposed (MN-major B).  P enters that product as two bf16
// terms, hi = bf16(p) and lo = bf16(p - hi), so it keeps ~16 bits of
// mantissa: one bf16 term (FlashAttention-3's choice) adds a 2^-9 relative
// error to every probability, as large as the bf16 rounding of the output
// itself, and moves outputs past the one-ulp tolerance the port holds its
// kernels to.  The lo term costs one more wgmma per P V step (1.5x the
// tensor work).  Where the tensor cores bound the loop (flash) the softmax
// of tile k + 1 runs while P V of tile k is in flight (P::kOverlap); where
// bytes bound it (paged decode) one tile at a time keeps a stage free for
// the next load.
//
// Element type.  The operands are bf16 or fp16 (E = BF16 or F16 below:
// the problem's P::E); only the wgmma operand type, the TMA data type and
// the conversions of P and of the output differ.  fp16 keeps the hi + lo
// split of P: one fp16 term rounds a probability by up to 2^-11 of
// itself, as much as the output's own fp16 rounding, against a kernel
// tolerance of 2^-10 (chip_smoke.py), and one code path serves both
// types.  The lo term of a probability below 2^-3 falls into fp16's
// subnormals and, below ~2^-13, to 0: an absolute error under 2^-25 a
// probability, far under the output's rounding.
//
// Row invariance.  Every f32 step of the softmax is an explicit
// round-to-nearest intrinsic or a single fixed instruction (no contraction
// can differ between code paths), a tile with no visible key for a row
// leaves its m, l and O bitwise unchanged, and each row's products are its
// own wgmma rows.  So a row's bits depend only on its q vector and its
// visible keys, taken in fixed 64-key tiles from key 0: not on its place in
// the tile, the tile count, NC, or how many keys the CTA's other rows see.
//
// int8 K/V (P::kInt8, the int8 pool with one f32 scale per token).  A
// third loader policy: the producer warp's TMA boxes bring int8 K and V
// (half the bf16 bytes) and their per-token scales into a ring of S8
// staging slots, and the producer warpgroup's three other warps (idle
// for bf16) convert each arrived slot into the bf16 K/V stage, in the
// swizzled atom layout below.  int8 values in [-128, 127] are exact in
// bf16, so K and V reach wgmma as unscaled integers: S = Q K^T is exact
// products summed in f32 and the scales stay out of the tensor cores.
// The K scale multiplies S's column j in f32 (S_ij = (q_i . k_j) s_kj,
// before the log2 scaling and the mask), the V scale multiplies
// probability p_ij after l has taken it and before the hi/lo split (O =
// sum_j (p_ij s_vj) v_j, l = sum_j p_ij): two per-element multiplies, so
// row invariance holds as for bf16.  A converter thread writes its
// chunks, then fence.proxy.async (its generic stores become visible to
// wgmma's async-proxy reads), then arrives on a barrier of the stage (96
// arrivals, no bytes).  K and V have a barrier pair each, so the
// converters write K of tile k + 1 while the consumers' P V of tile k
// runs, and V of k + 1 during their Q K^T and softmax of k + 1.  Each
// half is converted whole (any int8 byte is a finite bf16) and the
// staging scales start at 0, so slots that a tail tile loads in part
// stay finite.  The ring is one stage deep at NC = 1 (decode: S8 = 3
// slots of int8 in flight, two CTAs a multiprocessor) and as bf16 at
// NC = 2; the converters get 56 registers (the consumers 200 or 224).
// The conversion's cost is shared-memory traffic and converter time: a
// 64-key tile moves ~128 KB through shared memory (Q K^T reads 32 KB,
// the two P V terms 32 KB, TMA writes 16.5 KB, the conversion reads
// 16 KB and writes 32 KB) against bf16's ~96 KB, and at decode the
// converters' work on a tile outlasts the consumers', so the path runs
// slower than bf16's for all its halved HBM bytes.
//
// Shared memory.  Tiles are stored as 128-byte-swizzled atoms of
// [64 rows x 64 bf16 columns] (8 KB), the layout TMA's SWIZZLE_128B writes
// and wgmma's 128B descriptors read.  A head dim that is not a multiple of
// 64 is padded to the next one (48 -> 64, 80 -> 128, 160 -> 192): TMA fills
// the columns past D with zeros (the tensor map's inner dimension is D, the
// box 64 wide), Q K^T stops at the last k16 step that holds real columns,
// and P V computes the padded output columns and drops them.  The same
// swizzle serves every D; the padding costs D=80 its P V product at N=128.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

// The two 16-bit element types of the tensor-core kernels.  Each names
// its wgmma operand type (kHalf), its TMA data type and its conversions
// from f32, all by intrinsics (a build that defines
// __CUDA_NO_HALF_CONVERSIONS__ refuses the implicit ones).  Only the
// operands are E: scores, softmax and accumulators stay f32.
struct BF16 {
  typedef __nv_bfloat16 T;
  typedef __nv_bfloat162 T2;
  static constexpr bool kHalf = false;
  static constexpr uint32_t kMagic = 0x43434343u;  // see i8x4_to
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ T2 pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ float2 unpack(T2 v) {
    return __bfloat1622float2(v);
  }
  __device__ static __forceinline__ T one(float x) { return __float2bfloat16_rn(x); }
  __device__ static __forceinline__ T2 sub2(uint32_t a, uint32_t b) {
    return __hsub2(*reinterpret_cast<T2*>(&a), *reinterpret_cast<T2*>(&b));
  }
};
struct F16 {
  typedef __half T;
  typedef __half2 T2;
  static constexpr bool kHalf = true;
  static constexpr uint32_t kMagic = 0x64646464u;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static __forceinline__ T2 pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  __device__ static __forceinline__ float2 unpack(T2 v) { return __half22float2(v); }
  __device__ static __forceinline__ T one(float x) { return __float2half_rn(x); }
  __device__ static __forceinline__ T2 sub2(uint32_t a, uint32_t b) {
    return __hsub2(*reinterpret_cast<T2*>(&a), *reinterpret_cast<T2*>(&b));
  }
};

constexpr int BM = 64;                  // query vectors per consumer warpgroup
constexpr int BN = 64;                  // keys per K/V tile
constexpr int ATOM = 64;                // 16-bit columns of one 128-byte swizzle atom
constexpr int ATOM_BYTES = BN * 128;    // one [64 rows x 64 columns] atom
constexpr int NO_LIMIT = INT_MAX / 2;   // last visible key of a row without a causal bound
constexpr float NEG_INF = -1e30f;       // running-max floor: exp2(m - m_new) stays finite
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static constexpr int DA = (D + ATOM - 1) / ATOM;  // swizzle atoms across the head
  static constexpr int DP = DA * ATOM;              // padded row (zero past D)
  static constexpr int KS = (D + 15) / 16;          // k16 steps of Q K^T
  static constexpr int TILE = DA * ATOM_BYTES;      // one [64 x DP] tile
};

// K/V ring depth: as many stages as fit beside the Q tiles (two CTAs a
// multiprocessor for NC = 1)
template <int D, int NC>
__host__ __device__ constexpr int stages() {
  return NC == 1 || Dims<D>::DA >= 3 ? 2 : 3;
}

// int8 K/V: converter threads (warps 1..3 of the producer warpgroup), and
// one staging slot: K [64 keys][D] and V int8, then the 64 K and 64 V
// scales (f32)
constexpr int CONVERTERS = 96;
template <int D>
struct Staged {
  static constexpr int KV = BN * D;
  static constexpr int BYTES = 2 * KV + 2 * BN * 4;
};

// the bf16 K/V ring's depth and the int8 staging slots (0 for bf16 K/V)
template <int D, int NC, class P>
__host__ __device__ constexpr int ring_stages() {
  return P::kInt8 && NC == 1 ? 1 : stages<D, NC>();
}
template <int D, int NC, class P>
__host__ __device__ constexpr int staged_slots() {
  return !P::kInt8 ? 0 : NC == 1 ? 3 : 2;
}

template <int D, int NC, class P>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int ST = ring_stages<D, NC, P>(), S8 = staged_slots<D, NC, P>();
  return 1024 + (size_t)(NC + 2 * ST) * Dims<D>::TILE +
         (S8 ? (size_t)ST * 2 * BN * 4 + (size_t)S8 * Staged<D>::BYTES : 0) +
         64 * 8;
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the phase of the given parity to complete.  The spin is one
// PTX loop (no divergent C++ control flow in front of the wgmma that
// follow); a wait longer than 10 s (a lost arrival) traps, an error the
// launch reports, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
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

// one TMA box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// a contiguous global range into shared memory, completing on bar
// (bytes, addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the program: reads of a wgmma result are
// not hoisted above the wait that retires it (which would serialise the
// wgmma), nor its inputs' updates sunk below.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of 128-byte-swizzled atoms: lbo and sbo
// in bytes (K-major: lbo unused, sbo = 1024, the next 8 rows; MN-major: lbo
// = the next 64 columns' atom, sbo = 1024, the next 8 rows of K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// S (64 x 64, f32) {+}= A (64 x 16, smem) . B (16 x 64, smem), both K-major
#define SM90_WGMMA_SS_N64(TY)                                                          \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %34, 0;\n"                                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                      \
      "{"                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                         \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "l"(da), "l"(db), "r"(accumulate))
template <class E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (E::kHalf)
    SM90_WGMMA_SS_N64("f16");
  else
    SM90_WGMMA_SS_N64("bf16");
}

// S (64 x 32, f32) {+}= A (64 x 16, smem) . B (16 x 32, smem), both K-major
#define SM90_WGMMA_SS_N32(TY)                                                      \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %18, 0;\n"                                                   \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                  \
      "{"                                                                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                       \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                         \
      : "l"(da), "l"(db), "r"(accumulate))
template <class E>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (E::kHalf)
    SM90_WGMMA_SS_N32("f16");
  else
    SM90_WGMMA_SS_N32("bf16");
}

// O (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
#define SM90_WGMMA_RS_N64(TY)                                                          \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %37, 0;\n"                                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                      \
      "{"                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                         \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <class E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (E::kHalf)
    SM90_WGMMA_RS_N64("f16");
  else
    SM90_WGMMA_RS_N64("bf16");
}

// O (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
#define SM90_WGMMA_RS_N128(TY)                                                         \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %69, 0;\n"                                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                     \
      "{"                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                       \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                         \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <class E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (E::kHalf)
    SM90_WGMMA_RS_N128("f16");
  else
    SM90_WGMMA_RS_N128("bf16");
}

// O (64 x 192, f32) += A (64 x 16, registers) . B (16 x 192, smem, MN-major)
#define SM90_WGMMA_RS_N192(TY)                                                         \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %101, 0;\n"                                                      \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " "                     \
      "{"                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                       \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                                       \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                                       \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                                       \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                                       \
      "%88, %89, %90, %91, %92, %93, %94, %95"                                         \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),  \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),  \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <class E>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (E::kHalf)
    SM90_WGMMA_RS_N192("f16");
  else
    SM90_WGMMA_RS_N192("bf16");
}
template <class E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64<E>(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128<E>(d, a, db);
  if constexpr (N == 192) wgmma_rs_n192<E>(d, a, db);
}

template <class V>
__device__ __forceinline__ uint32_t pair_bits(V v) {
  static_assert(sizeof(V) == 4, "a pair of 16-bit values");
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0 (lower column) and x1 -> the hi and lo E pairs.  An fp16 value past
// 65504 (a dS under a large loss scale) rounds to inf, its lo term to
// -inf, and the product that takes both is not finite: the gradient
// comes out inf or NaN, which a GradScaler reads as an overflow.
template <class E>
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const typename E::T2 h = E::pack(x0, x1);
  const float2 hf = E::unpack(h);
  hi = pair_bits(h);
  lo = pair_bits(E::pack(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y)));
}

// 2^x in one MUFU op (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum of 16 values in one fixed pairwise order
__device__ __forceinline__ float max16(const float (&v)[16]) {
  float a[8], b[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = fmaxf(v[2 * i], v[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = fmaxf(a[2 * i], a[2 * i + 1]);
  return fmaxf(fmaxf(b[0], b[1]), fmaxf(b[2], b[3]));
}
__device__ __forceinline__ float sum16(const float (&v)[16]) {
  float a[8], b[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __fadd_rn(a[2 * i], a[2 * i + 1]);
  return __fadd_rn(__fadd_rn(b[0], b[1]), __fadd_rn(b[2], b[3]));
}

// S = Q K^T of one K tile (64 keys, or 32 for a 16-register S) into f32
// registers (issued, not waited)
template <class E, int KS, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N], uint32_t qa,
                                         uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
    const uint64_t da = desc_sw128(qa + off, 16, 1024);
    const uint64_t db = desc_sw128(ka + off, 16, 1024);
    if constexpr (N == 32) wgmma_ss_n64<E>(s, da, db, kk > 0);
    if constexpr (N == 16) wgmma_ss_n32<E>(s, da, db, kk > 0);
  }
}

// O += P V over NKK k16 steps (the 16 NKK rows of V from va), P as its hi
// and lo terms (issued, not waited)
template <class E, int DP, int NKK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&ph)[NKK][4],
                                         const uint32_t (&pl)[NKK][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const uint64_t dv = desc_sw128(va + kk * 16 * 128, ATOM_BYTES, 1024);
    wgmma_rs<E, DP>(o, ph[kk], dv);
    wgmma_rs<E, DP>(o, pl[kk], dv);
  }
}

// One online-softmax step over this thread's rows (hf 0: row i0, hf 1:
// i0 + 8; the quad of lanes 4g .. 4g + 3 holds a row's 64 scores): s
// becomes the tile's probabilities, m and l move on, and alpha is the
// factor O is scaled by before this tile's P V.  key0 is the tile's first
// key, last[hf] a row's last visible key, kl the key limit.  MASK = false
// for a tile every row sees whole; no branch either way.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int key0, int kl,
                                             const int (&last)[2], int t,
                                             float sl2) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    bool vis[16];
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = key0 + 8 * (i / 2) + 2 * t + i % 2;
      vis[i] = !MASK || (key < kl && key <= last[hf]);
      v[i] = vis[i] ? s[4 * (i / 2) + 2 * hf + i % 2] : -INFINITY;
    }
    float mr = max16(v);
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float mn = mr == -INFINITY ? m[hf] : fmaxf(m[hf], __fmul_rn(mr, sl2));
    alpha[hf] = ex2(__fsub_rn(m[hf], mn));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float& x = s[4 * (i / 2) + 2 * hf + i % 2];
      const float e = ex2(__fmaf_rn(x, sl2, -mn));
      x = vis[i] ? e : 0.f;
      v[i] = x;
    }
    float ps = sum16(v);
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 1));
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 2));
    l[hf] = __fmaf_rn(l[hf], alpha[hf], ps);
    m[hf] = mn;
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = __fmul_rn(o[i], alpha[(i / 2) % 2]);
}

// P as hi + lo A fragments: k16 step kk holds key blocks 2kk, 2kk + 1
template <class E, int NKK>
__device__ __forceinline__ void to_hi_lo(const float (&s)[8 * NKK],
                                         uint32_t (&ph)[NKK][4],
                                         uint32_t (&pl)[NKK][4]) {
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_hi_lo<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
}

// int8 bytes b0..b3 of w -> the exact E pairs (b0, b1) and (b2, b3).
// With kMagic's byte X (bf16 0x43, fp16 0x64), 0xXXmm is B + m for the
// low seven bits m and 0xXX80 is B + 128 (bf16 B = 128, fp16 B = 1024),
// so (B + m) - (B + 128 s) for sign bit s is the two's complement value,
// exact in one subtraction
template <class E>
__device__ __forceinline__ void i8x4_to(uint32_t w, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  lo = pair_bits(E::sub2(__byte_perm(mag, E::kMagic, 0x4140),
                         __byte_perm(sgn, E::kMagic, 0x4140)));
  hi = pair_bits(E::sub2(__byte_perm(mag, E::kMagic, 0x4342),
                         __byte_perm(sgn, E::kMagic, 0x4342)));
}

// One half of a staging slot (int8 K or V [64 keys][D] at src, its 64
// scales at ssc) into the bf16 tile (swizzled atoms) and the stage's
// scales, by converter thread tid of CONVERTERS.  A thread takes one
// 16-byte chunk (16 values of a key row) at a time; the 8 lanes of a
// shared-memory phase read 8 distinct bank groups and write 8 distinct
// ones (at D = 128 the key row of the chunks past column 63 alternates,
// r ^ 1, so the two atoms' writes land in the two halves of the
// swizzle's bank groups).
template <class E, int D>
__device__ __forceinline__ void convert_half(const uint8_t* src,
                                             const float* ssc, uint8_t* dst,
                                             float* sc, int tid) {
  constexpr int CPR = D / 16;  // 16-byte int8 chunks a key row
  static_assert(CPR == 4 || CPR == 8, "int8 K/V: head dim 64 or 128");
#pragma unroll 2
  for (int q = tid; q < BN * CPR; q += CONVERTERS) {
    const int c8 = q % CPR;
    int r = q / CPR;
    if constexpr (CPR == 8) r ^= c8 >> 2;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * D + c8 * 16);
    uint4 x, y;
    i8x4_to<E>(w.x, x.x, x.y);
    i8x4_to<E>(w.y, x.z, x.w);
    i8x4_to<E>(w.z, y.x, y.y);
    i8x4_to<E>(w.w, y.z, y.w);
    uint8_t* row = dst + (c8 * 16 / ATOM) * ATOM_BYTES + r * 128;
    const int c = (c8 * 16 % ATOM) / 8;  // the first of its two 16-byte chunks
    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = x;
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) = y;
  }
  if (tid < BN / 4)
    reinterpret_cast<float4*>(sc)[tid] = reinterpret_cast<const float4*>(ssc)[tid];
}

// s[n] *= the scale of its key column: this thread's 16 columns are 8 q +
// 2 t and 8 q + 2 t + 1 (q = 0 .. 7), for both of its rows
__device__ __forceinline__ void scale_cols(float (&s)[32], const float* sc,
                                           int t) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 f = *reinterpret_cast<const float2*>(sc + 8 * q + 2 * t);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      s[4 * q + 2 * hf] = __fmul_rn(s[4 * q + 2 * hf], f.x);
      s[4 * q + 2 * hf + 1] = __fmul_rn(s[4 * q + 2 * hf + 1], f.y);
    }
  }
}

// keys visible to one consumer warpgroup's tile: none when it has no valid
// vector, else up to its deepest row's last visible key, capped at klim
template <class P>
__device__ __forceinline__ int tiles_of(const P& p, const typename P::Cta& c,
                                        int tile) {
  const int nv = p.n_valid(c, tile);
  if (nv <= 0) return 0;
  const int last = p.diag(c, tile, nv - 1);
  if (last < 0) return 0;
  return min((p.klim(c) + BN - 1) / BN, last / BN + 1);
}

// ---------------------------------------------------------------- kernel
// P (the problem) supplies: Cta cta(nc) (this block's batch, heads, first
// tile and whatever its loads need), n_valid / diag / klim (which vectors
// exist and the last key each sees), q_box_bytes / load_q, load_kv (one
// K/V tile, called by the whole producer warp), out_row and store_lse, and
// three choices: kOverlap (the consumers' loop, see Math above),
// kZeroRing (zero the K/V ring first, for a loader that fills stages in
// part) and kInt8 (int8 K/V, see above: load_kv then fills a staging slot
// of Staged<D> layout, K and V at 0 and KV, the scales after them).
template <int D, int NC, class P>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
attention_fwd_kernel(const __grid_constant__ P p) {
  using T = Dims<D>;
  using E = typename P::E;
  constexpr int ST = ring_stages<D, NC, P>();
  constexpr int S8 = staged_slots<D, NC, P>();
  static_assert(!(S8 && P::kOverlap), "int8 K/V: one tile at a time");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;                       // NC tiles
  uint8_t* sK = sQ + NC * T::TILE;          // ST tiles
  uint8_t* sV = sK + ST * T::TILE;          // ST tiles
  // int8 K/V only: ST x [64 K scales, 64 V scales], S8 staging slots
  float* sSc = reinterpret_cast<float*>(sV + ST * T::TILE);
  uint8_t* s8 = reinterpret_cast<uint8_t*>(sSc + (S8 ? ST * 2 * BN : 0));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s8 + S8 * Staged<D>::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  // int8 K/V: full marks the stage's K converted and empty its V
  // released; fullV and emptyK are the other two, so that the
  // converters' work on one half overlaps the consumers' on the other
  uint64_t* full8 = empty + ST;             // S8 each
  uint64_t* empty8 = full8 + S8;
  uint64_t* fullV = empty8 + S8;            // ST each (int8 K/V only)
  uint64_t* emptyK = fullV + (S8 ? ST : 0);
  constexpr int kProducerRegs = S8 ? 56 : 40;
  constexpr int kConsumerRegs = NC == 1 ? (S8 ? 200 : 216) : (S8 ? 224 : 232);

  // warp and warpgroup indices broadcast from lane 0, so the compiler
  // knows them warp-uniform and the role branch is not divergent (a
  // divergent path serialises every wgmma)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const typename P::Cta c = p.cta(NC);
  int n_tiles = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) n_tiles = max(n_tiles, tiles_of(p, c, c.tile0 + w));

  if constexpr (P::kZeroRing) {
    // stages the producer fills only in part keep finite values
    uint4* z = reinterpret_cast<uint4*>(sK);
    for (int i = threadIdx.x; i < 2 * ST * T::TILE / 16; i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (S8 > 0) {
    // the staging scales of columns a tail tile does not load stay 0
    for (int i = threadIdx.x; i < S8 * 2 * BN; i += blockDim.x)
      reinterpret_cast<float*>(s8 + (i / (2 * BN)) * Staged<D>::BYTES +
                               2 * Staged<D>::KV)[i % (2 * BN)] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], S8 ? CONVERTERS : 1);
      mbar_init(&empty[s], 4 * NC);
    }
    for (int s = 0; s < S8; ++s) {
      mbar_init(&full8[s], 1);
      mbar_init(&empty8[s], CONVERTERS);
    }
    for (int s = 0; s < (S8 ? ST : 0); ++s) {
      mbar_init(&fullV[s], CONVERTERS);
      mbar_init(&emptyK[s], 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp == 4 * NC) {
      if (lane == 0) {
        uint32_t bytes = 0;
        for (int w = 0; w < NC; ++w)
          if (tiles_of(p, c, c.tile0 + w) > 0) bytes += T::DA * p.q_box_bytes();
        mbar_expect_tx(q_full, bytes);
        for (int w = 0; w < NC; ++w)
          if (tiles_of(p, c, c.tile0 + w) > 0)
            for (int a = 0; a < T::DA; ++a)
              p.load_q(c, c.tile0 + w, sQ + w * T::TILE + a * ATOM_BYTES, q_full, a);
      }
      int state = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        if constexpr (S8 > 0) {
          const int ss = kt % S8;
          mbar_wait(&empty8[ss], ((kt / S8) & 1) ^ 1);
          p.template load_kv<T::DA>(c, kt, s8 + ss * Staged<D>::BYTES,
                                    &full8[ss], lane, state);
        } else {
          const int st = kt % ST;
          mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
          p.template load_kv<T::DA>(c, kt, sK + st * T::TILE,
                                    sV + st * T::TILE, &full[st], lane, state);
        }
      }
    } else if constexpr (S8 > 0) {
      // converters: staging slot -> bf16 stage, K once the consumers'
      // Q K^T has released the stage's K, V once their P V has released
      // its V
      const int tid = threadIdx.x - 128 * NC - 32;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int ss = kt % S8, st = kt % ST, ph = (kt / ST) & 1;
        const uint8_t* src = s8 + ss * Staged<D>::BYTES;
        const float* ssc = reinterpret_cast<const float*>(src + 2 * Staged<D>::KV);
        float* sc = sSc + st * 2 * BN;
        mbar_wait(&full8[ss], (kt / S8) & 1);
        mbar_wait(&emptyK[st], ph ^ 1);
        convert_half<E, D>(src, ssc, sK + st * T::TILE, sc, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[st]);
        mbar_wait(&empty[st], ph ^ 1);
        convert_half<E, D>(src + Staged<D>::KV, ssc + BN, sV + st * T::TILE,
                        sc + BN, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&empty8[ss]);
        mbar_arrive(&fullV[st]);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int tile = c.tile0 + wg;
    const int my = tiles_of(p, c, tile);
    const int nv = p.n_valid(c, tile);
    const int g = lane / 4, t = lane % 4;
    const int i0 = (warp % 4) * 16 + g;   // this thread's rows: i0 and i0 + 8
    const int kl = p.klim(c);
    const int dmin = p.diag(c, tile, 0);
    const int dr[2] = {p.diag(c, tile, i0), p.diag(c, tile, i0 + 8)};
    const float sl2 = p.sl2;
    const uint32_t qa = smem_u32(sQ + wg * T::TILE);

    float o[T::DP / 2];
#pragma unroll
    for (int n = 0; n < T::DP / 2; ++n) o[n] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    if (my > 0) mbar_wait(q_full, 0);


    float s[32], alpha[2];
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = 0.f;
    const auto softmax = [&](int kt) {
      const int key0 = kt * BN;
      if (key0 + BN <= kl && key0 + BN - 1 <= dmin)
        softmax_tile<false>(s, m, l, alpha, key0, kl, dr, t, sl2);
      else
        softmax_tile<true>(s, m, l, alpha, key0, kl, dr, t, sl2);
    };
    if constexpr (P::kOverlap) {
      // Tile kt's P V runs on the tensor cores while the softmax of tile
      // kt + 1 runs on the CUDA cores: S of kt + 1 is issued first, P V
      // of kt second, and the wait for the first leaves the second in
      // flight; O is rescaled for kt + 1 once P V of kt has landed.  The
      // loop body is straight-line (the last tile peeled off): no branch
      // around a wgmma, so the compiler can tell which group each wait
      // retires.  It holds two stages at once, so it suits a loop bounded
      // by the tensor cores, not one bounded by bytes.
      if (my > 0) {
        mbar_wait(&full[0], 0);
        wgmma_fence();
        issue_qk<E, T::KS>(s, qa, smem_u32(sK));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax(0);  // O is still 0: no rescale
        to_hi_lo<E>(s, ph, pl);
      }
      for (int kt = 0; kt + 1 < my; ++kt) {
        const int st = kt % ST, sn = (kt + 1) % ST;
        mbar_wait(&full[sn], ((kt + 1) / ST) & 1);
        fence_regs(o);
        wgmma_fence();
        issue_qk<E, T::KS>(s, qa, smem_u32(sK + sn * T::TILE));
        wgmma_commit();
        issue_pv<E, T::DP>(o, ph, pl, smem_u32(sV + st * T::TILE));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        softmax(kt + 1);
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        rescale<T::DP>(o, alpha);
        to_hi_lo<E>(s, ph, pl);
      }
      if (my > 0) {
        const int st = (my - 1) % ST;
        fence_regs(o);
        wgmma_fence();
        issue_pv<E, T::DP>(o, ph, pl, smem_u32(sV + st * T::TILE));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    } else {
      // one tile at a time: the producer keeps every other stage loading
      for (int kt = 0; kt < my; ++kt) {
        const int st = kt % ST;
        mbar_wait(&full[st], (kt / ST) & 1);
        wgmma_fence();
        issue_qk<E, T::KS>(s, qa, smem_u32(sK + st * T::TILE));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if constexpr (S8 > 0) {
          scale_cols(s, sSc + st * 2 * BN, t);
          __syncwarp();
          if (lane == 0) mbar_arrive(&emptyK[st]);
        }
        softmax(kt);
        rescale<T::DP>(o, alpha);
        if constexpr (S8 > 0) {
          mbar_wait(&fullV[st], (kt / ST) & 1);
          scale_cols(s, sSc + st * 2 * BN + BN, t);
        }
        to_hi_lo<E>(s, ph, pl);
        fence_regs(o);
        wgmma_fence();
        issue_pv<E, T::DP>(o, ph, pl, smem_u32(sV + st * T::TILE));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }
    // tiles past this warpgroup's rows: release them for the other one
    for (int kt = my; kt < n_tiles; ++kt) {
      const int st = kt % ST;
      mbar_wait(&full[st], (kt / ST) & 1);
      if constexpr (S8 > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&emptyK[st]);
        mbar_wait(&fullV[st], (kt / ST) & 1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: O / l in E; a row that saw no key outputs 0
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + 8 * hf;
      if (i >= nv) continue;
      const bool any = l[hf] > 0.f;
      typename E::T* op = p.template out_row<D>(c, tile, i) + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float x0 = any ? __fdiv_rn(o[4 * n + 2 * hf], l[hf]) : 0.f;
        const float x1 = any ? __fdiv_rn(o[4 * n + 2 * hf + 1], l[hf]) : 0.f;
        *reinterpret_cast<typename E::T2*>(op + 8 * n) = E::pack(x0, x1);
      }
      if (t == 0)
        p.store_lse(c, tile, i,
                    any ? __fmaf_rn(m[hf], LN2, logf(l[hf])) : -INFINITY);
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against cudart alone (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

// A 4-D tensor [d3][d2][d1][d0] of `type` (d0 contiguous; s1..s3 the
// byte strides of d1..d3) read in boxes of {b0, b1, b2, b3} elements into
// shared memory under `swizzle`; elements out of bounds read as 0.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                       uint64_t d3, uint64_t s1, uint64_t s2, uint64_t s3,
                       uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "attention_sm90: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint64_t dims[4] = {d0, d1 ? d1 : 1, d2 ? d2 : 1, d3 ? d3 : 1};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {b0, b1, b2, b3};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "attention_sm90: cuTensorMapEncodeTiled error %d\n", (int)r);
    return false;
  }
  return true;
}

// E in boxes of {64, b1, b2, b3} into 128-byte-swizzled atoms
template <class E>
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint64_t d3, uint64_t s1,
                     uint64_t s2, uint64_t s3, uint32_t b1, uint32_t b2,
                     uint32_t b3) {
  return encode_map(map, E::kMap, ptr, d0, d1, d2, d3,
                    s1, s2, s3, ATOM, b1, b2, b3, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int NC, class P>
cudaError_t launch(const P& p, dim3 grid, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<D, NC, P>;
  constexpr size_t smem = smem_bytes<D, NC, P>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 128 * (NC + 1), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
