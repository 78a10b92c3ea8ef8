// The Hopper flash-attention backward, for sm_90a: dQ and dK/dV from the
// saved lse and delta = rowsum(dO * O) (the recompute form of
// paddle_tpu/ops/pallas/flash.py's _dq_kernel :163 and _dkv_kernel :197),
// built from the machinery of attention_sm90.cuh: TMA-fed shared-memory
// rings with full/empty mbarriers, one producer warp, consumer warpgroups
// on wgmma, setmaxnreg 40 / 232.  Included by flash_attention.cu.
//
// Layout as the forward: q, dout, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KH, D]; lse, delta [B, H, Sq] f32.  GQA: q head h reads kv head
// h / (H / KH).  Causal: key j is visible from query i when
// i + (Sk - Sq) >= j.  A query with no visible key has lse = -inf; its
// probabilities are a literal 0 (a select, never a product), so its dQ
// row is 0 and it adds nothing to dK/dV.
//
// dQ.  A block owns two 64-row query tiles of one (q head, batch), one
// per consumer warpgroup; Q and dO of its rows arrive once by TMA, each
// row's lse (x log2 e) and delta sit in registers.  The producer keeps K/V
// tiles of 64 keys in a ring, up to the deeper tile's causal diagonal.
// Per key tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands
// K-major in shared memory); P = exp2(S scale log2 e - lse) under a
// branch-free mask; dS = P (dP - delta) scale; dQ += dS K (wgmma m64nDPk16,
// dS from registers, K read MN-major as V in the forward's P V).  The S /
// dP products of tile k + 1 are issued before dQ of tile k, so the
// CUDA-core work of one tile runs while the other's products are in
// flight.  Blocks run longest-first.
//
// dK/dV.  A block owns 64 keys per consumer warpgroup (two warpgroups, 128
// keys) of one (kv head, batch); K and V arrive once by TMA.  The producer
// walks the group's H / KH query heads in order and, within a head, the
// query tiles of 64 from the first one that sees the block's keys; a stage
// holds the Q and dO tiles (TMA) and the tile's 64 lse and delta values
// (written by the producer warp's lanes, one arrival each).  Scores are
// transposed (rows = keys, the wgmma M; columns = queries): S^T = K Q^T,
// dP^T = V dO^T; P^T and dS^T overwrite them in place; P^T becomes A
// fragments and dV += P^T dO is issued, then dS^T becomes A fragments and
// dK += dS^T Q is issued.  dK and dV accumulate in f32 registers, in one
// fixed order (query heads, then query tiles): no atomics, so the result
// is deterministic.  The accumulators take DP f32 registers a thread, so
// the scores are cut to fit beside them: at DP = 64 a step takes the
// whole tile of 64 queries (S^T, dP^T and the fragments: 96 registers;
// dV retires before dS^T's fragments take P^T's registers); at DP = 128
// two steps of 32 queries (wgmma m64n32k16 for S^T and dP^T, 64
// registers: with 64-query steps ptxas spilled and serialised every
// wgmma, in every order of the products tried on the card); at DP = 192
// (D 160) the two warpgroups share one tile of 64 keys: warpgroup 0
// computes S^T and dV, warpgroup 1 S^T, dP^T and dK (S^T runs twice; the
// UNet runs D 160 only at 256 and 64 tokens).
//
// Query split.  Where the key tiles alone leave the card without work
// (the UNet's cross-attention: 77 keys), the wrapper asks for NS > 1
// contiguous ranges of query tiles.
// Each split writes its f32 partial sums to a workspace [2, NS, B, Sk, KH,
// D] (dK, then dV), and flash_bwd_dkv_reduce_kernel adds the NS partials
// in index order and rounds to E.  NS = 1 writes E directly.  NS is
// a pure function of the shape, so the result stays deterministic.
//
// Precision.  P and dS enter their second products as hi + lo terms of
// the element type E (bf16 or fp16, as the forward's; see
// attention_sm90.cuh), as P does in the forward (one bf16 term adds a
// 2^-9 relative error to each, against the one-ulp tolerance the port
// holds its kernels to).  In fp16 a dS past 65504 (a large loss scale)
// leaves dQ and dK inf or NaN, as JAX's ds.astype(k.dtype) does
// (flash.py:183, :226): a GradScaler skips that step.
// Bound: 6 D (dQ) and 8 D (dK/dV) flops per visible (query, key) pair and
// query head; the lo terms add 2 D to each, so dQ issues 8 D (4/3 of its
// bound's tensor work) and dK/dV 12 D (3/2), and D 160's shared key tile
// adds another 2 D of S^T.  Head dims 48, 80 and 160 pad to 64, 128 and 192
// through TMA's zero fill as in the forward: the score products stop at
// the last k16 step with real columns, the rs products compute the padded
// columns and the epilogue drops them.

#pragma once

#include "attention_sm90.cuh"

namespace sm90 {

struct BwdArgs {
  CUtensorMap tq, tdo, tk, tv;  // q, dout [B, Sq, H, D]; k, v [B, Sk, KH, D]
  const float* lse;             // [B, H, Sq]
  const float* delta;           // [B, H, Sq]
  void* dq;                     // E (bf16 or fp16, as q)
  void* dk;
  void* dv;
  float* ws;                    // [2, NS, B, Sk, KH, D] f32 when NS > 1
  int B, Sq, Sk, H, KH, causal, splits;
  float scale, sl2;             // sl2 = scale * log2 e
};

constexpr int BWD_THREADS = 384;  // two consumer warpgroups, one producer

// dQ: the forward's K/V ring depth beside two Q and two dO tiles
template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return 1024 + (size_t)(4 + 2 * stages<D, 2>()) * Dims<D>::TILE + 64 * 8;
}

// dK/dV: at DP = 192 two warpgroups share one key tile, and at DP = 128
// a query tile is taken as two halves of 32 columns (see above)
template <int D>
__host__ __device__ constexpr bool dkv_shared_keys() { return Dims<D>::DP > 128; }
template <int D>
__host__ __device__ constexpr int dkv_cols() { return Dims<D>::DP == 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int dkv_key_tiles() { return dkv_shared_keys<D>() ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_stages() { return Dims<D>::DA >= 3 ? 2 : 3; }
template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return 1024 +
         (size_t)(2 * dkv_key_tiles<D>() + 2 * dkv_stages<D>()) * Dims<D>::TILE +
         (size_t)dkv_stages<D>() * 2 * BM * sizeof(float) + 64 * 8;
}

// dS of one tile in place of s, rows = queries (this thread's i0, i0 + 8),
// columns = keys from key0: P = exp2(s sl2 - lse2), literal 0 where a key
// is past kl or the row's last visible key; MASK = false for a tile every
// row sees whole
template <bool MASK>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], int key0, int kl,
                                        const int (&last)[2], int t, float sl2,
                                        float scale) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int idx = 4 * (i / 2) + 2 * hf + i % 2;
      const int key = key0 + 8 * (i / 2) + 2 * t + i % 2;
      const bool vis = !MASK || (key < kl && key <= last[hf]);
      const float p = ex2(__fmaf_rn(s[idx], sl2, -lse2[hf]));
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[idx], dl[hf])), scale);
      s[idx] = vis ? ds : 0.f;
    }
}

// P^T (in s) and, with DS, dS^T (in dp) of one transposed tile: rows =
// keys kr[0], kr[1]; columns = queries q0 + 8 j + 2 t + e, whose lse2 and
// delta come from the stage (sl, sd).  A pair is visible when the query
// is below Sq, the key below Sk and, causal, q + off >= key.
template <bool MASK, bool DS, int NB>
__device__ __forceinline__ void p_ds_cols(float (&s)[4 * NB],
                                          float (&dp)[4 * NB],
                                          const float* sl, const float* sd,
                                          int q0, int Sq, int Sk, int off,
                                          int causal, const int (&kr)[2], int t,
                                          float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + 8 * j + 2 * t + e;
      const float lc = e ? l2.y : l2.x, dc = e ? d2.y : d2.x;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int idx = 4 * j + 2 * hf + e;
        const bool vis =
            !MASK || (q < Sq && kr[hf] < Sk && (!causal || q + off >= kr[hf]));
        const float e2 = ex2(__fmaf_rn(s[idx], sl2, -lc));
        const float p = vis ? e2 : 0.f;
        s[idx] = p;
        if constexpr (DS)
          dp[idx] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[idx], dc)), scale);
      }
    }
  }
}

// ------------------------------------------------------------------ dQ
template <class E, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ BwdArgs p) {
  using T = Dims<D>;
  constexpr int NC = 2;
  constexpr int ST = stages<D, NC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;                 // NC tiles
  uint8_t* sO = sQ + NC * T::TILE;    // dO, NC tiles
  uint8_t* sK = sO + NC * T::TILE;    // ST tiles
  uint8_t* sV = sK + ST * T::TILE;    // ST tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + ST * T::TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // the blocks of one (head, batch) run side by side, so its K/V tiles
  // are read from L2 (dQ does too little work a byte to stream them from
  // device memory), the deepest query tiles first
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (p.H / p.KH);
  const int tile0 = (gridDim.x - 1 - blockIdx.x) * NC;
  const int Sq = p.Sq, Sk = p.Sk, off = Sk - Sq;
  const int kt_all = (Sk + BN - 1) / BN;
  // key tiles that a query tile's rows see
  const auto n_valid = [&](int tile) { return max(0, min(BM, Sq - tile * BM)); };
  const auto tiles_of = [&](int tile) {
    const int nv = n_valid(tile);
    if (nv <= 0) return 0;
    if (!p.causal) return kt_all;
    const int last = tile * BM + nv - 1 + off;
    return last < 0 ? 0 : min(kt_all, last / BN + 1);
  };
  int n_tiles = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) n_tiles = max(n_tiles, tiles_of(tile0 + w));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * NC && lane == 0) {
      uint32_t bytes = 0;
      for (int w = 0; w < NC; ++w)
        if (tiles_of(tile0 + w) > 0) bytes += 2 * T::DA * ATOM_BYTES;
      mbar_expect_tx(q_full, bytes);
      for (int w = 0; w < NC; ++w)
        if (tiles_of(tile0 + w) > 0)
          for (int a = 0; a < T::DA; ++a) {
            tma_load_4d(sQ + w * T::TILE + a * ATOM_BYTES, &p.tq, q_full,
                        a * ATOM, h, (tile0 + w) * BM, b);
            tma_load_4d(sO + w * T::TILE + a * ATOM_BYTES, &p.tdo, q_full,
                        a * ATOM, h, (tile0 + w) * BM, b);
          }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % ST;
        mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * T::DA * ATOM_BYTES);
        for (int a = 0; a < T::DA; ++a) {
          tma_load_4d(sK + st * T::TILE + a * ATOM_BYTES, &p.tk, &full[st],
                      a * ATOM, kh, kt * BN, b);
          tma_load_4d(sV + st * T::TILE + a * ATOM_BYTES, &p.tv, &full[st],
                      a * ATOM, kh, kt * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tile = tile0 + wg;
    const int my = tiles_of(tile);
    const int nv = n_valid(tile);
    const int g = lane / 4, t = lane % 4;
    const int i0 = (warp % 4) * 16 + g;
    const int dmin = p.causal ? tile * BM + off : NO_LIMIT;
    int dr[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = tile * BM + i0 + 8 * hf;
      dr[hf] = p.causal ? r + off : NO_LIMIT;
      const size_t at = ((size_t)b * p.H + h) * Sq + r;
      lse2[hf] = r < Sq ? p.lse[at] * LOG2E : 0.f;
      dl[hf] = r < Sq ? p.delta[at] : 0.f;
    }
    const float sl2 = p.sl2, scale = p.scale;
    const uint32_t qa = smem_u32(sQ + wg * T::TILE);
    const uint32_t oa = smem_u32(sO + wg * T::TILE);

    float acc[T::DP / 2];
#pragma unroll
    for (int n = 0; n < T::DP / 2; ++n) acc[n] = 0.f;
    float s[32], dp[32];
    uint32_t dh[4][4], dlo[4][4];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = dp[n] = 0.f;
    const auto grad = [&](int kt) {
      const int key0 = kt * BN;
      if (key0 + BN <= Sk && key0 + BN - 1 <= dmin)
        ds_rows<false>(s, dp, lse2, dl, key0, Sk, dr, t, sl2, scale);
      else
        ds_rows<true>(s, dp, lse2, dl, key0, Sk, dr, t, sl2, scale);
    };
    if (my > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_qk<E, T::KS>(s, qa, smem_u32(sK));
      issue_qk<E, T::KS>(dp, oa, smem_u32(sV));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad(0);
      to_hi_lo<E>(s, dh, dlo);
    }
    // S and dP of tile kt + 1 are in flight with dQ += dS K of tile kt;
    // straight-line body, the last tile peeled (see attention_sm90.cuh)
    for (int kt = 0; kt + 1 < my; ++kt) {
      const int st = kt % ST, sn = (kt + 1) % ST;
      mbar_wait(&full[sn], ((kt + 1) / ST) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue_qk<E, T::KS>(s, qa, smem_u32(sK + sn * T::TILE));
      issue_qk<E, T::KS>(dp, oa, smem_u32(sV + sn * T::TILE));
      wgmma_commit();
      issue_pv<E, T::DP>(acc, dh, dlo, smem_u32(sK + st * T::TILE));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      grad(kt + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      to_hi_lo<E>(s, dh, dlo);
    }
    if (my > 0) {
      const int st = (my - 1) % ST;
      fence_regs(acc);
      wgmma_fence();
      issue_pv<E, T::DP>(acc, dh, dlo, smem_u32(sK + st * T::TILE));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // tiles past this warpgroup's rows: release them for the other one
    for (int kt = my; kt < n_tiles; ++kt) {
      const int st = kt % ST;
      mbar_wait(&full[st], (kt / ST) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + 8 * hf;
      if (i >= nv) continue;
      typename E::T* op = static_cast<typename E::T*>(p.dq) +
                          (((size_t)b * Sq + tile * BM + i) * p.H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<typename E::T2*>(op + 8 * n) =
            E::pack(acc[4 * n + 2 * hf], acc[4 * n + 2 * hf + 1]);
    }
  }
}

// --------------------------------------------------------------- dK/dV
// One consumer warpgroup's walk over the stages: the tiles before its
// first visible query tile are released unread, the rest computed.  DK,
// DV: which of the two it accumulates.
template <class E, int D, bool DK, bool DV>
__device__ __forceinline__ void dkv_consumer(
    const BwdArgs& p, uint8_t* sQ, uint8_t* sO, const float* sL,
    const float* sD, uint64_t* full, uint64_t* empty, uint32_t ka,
    uint32_t va, int k0, int b, int kh, int sp, int G, int qlo, int qf,
    int qe, int warp, int lane) {
  using T = Dims<D>;
  constexpr int ST = dkv_stages<D>();
  const int Sq = p.Sq, Sk = p.Sk, off = Sk - Sq, causal = p.causal;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp % 4) * 16 + g;
  const int kr[2] = {k0 + r0, k0 + r0 + 8};
  const float sl2 = p.sl2, scale = p.scale;

  float ak[DK ? T::DP / 2 : 1], av[DV ? T::DP / 2 : 1];
#pragma unroll
  for (int n = 0; n < (DK ? T::DP / 2 : 1); ++n) ak[n] = 0.f;
#pragma unroll
  for (int n = 0; n < (DV ? T::DP / 2 : 1); ++n) av[n] = 0.f;
  // query columns a step: the tile whole, or in two halves at DP = 128
  constexpr int QN = dkv_cols<D>(), NB = QN / 8, NKK = QN / 16;
  float s[4 * NB], dp[4 * NB];
#pragma unroll
  for (int n = 0; n < 4 * NB; ++n) s[n] = dp[n] = 0.f;
  uint32_t ph[NKK][4], pl[NKK][4], dh[NKK][4], dlo[NKK][4];

  int n = 0;
  for (int gh = 0; gh < G; ++gh) {
    for (int it = qlo; it < qf; ++it, ++n) {
      const int st = n % ST;
      mbar_wait(&full[st], (n / ST) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    for (int it = qf; it < qe; ++it, ++n) {
      const int st = n % ST;
      const uint32_t qa = smem_u32(sQ + st * T::TILE);
      const uint32_t oa = smem_u32(sO + st * T::TILE);
      mbar_wait(&full[st], (n / ST) & 1);
#pragma unroll
      for (int hc = 0; hc < BM / QN; ++hc) {
        const uint32_t qr = qa + hc * QN * 128, orow = oa + hc * QN * 128;
        if constexpr (DK) fence_regs(ak);
        if constexpr (DV) fence_regs(av);
        wgmma_fence();
        issue_qk<E, T::KS>(s, ka, qr);                     // S^T = K Q^T
        if constexpr (DK) issue_qk<E, T::KS>(dp, va, orow);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const int q0 = it * BM + hc * QN;
        const float* sl = sL + st * BM + hc * QN;
        const float* sd = sD + st * BM + hc * QN;
        if (q0 + QN <= Sq && k0 + BM <= Sk && (!causal || q0 + off >= k0 + BM - 1))
          p_ds_cols<false, DK, NB>(s, dp, sl, sd, q0, Sq, Sk, off, causal, kr, t, sl2, scale);
        else
          p_ds_cols<true, DK, NB>(s, dp, sl, sd, q0, Sq, Sk, off, causal, kr, t, sl2, scale);
        if constexpr (DV) {
          to_hi_lo<E>(s, ph, pl);
          wgmma_fence();
          issue_pv<E, T::DP>(av, ph, pl, orow);  // dV += P^T dO
          wgmma_commit();
        }
        if constexpr (DK) {
          if constexpr (DV && NB == 8) {
            // dV retires first, so dS^T's fragments can take P^T's registers
            wgmma_wait<0>();
            fence_regs(av);
          }
          to_hi_lo<E>(dp, dh, dlo);
          wgmma_fence();
          issue_pv<E, T::DP>(ak, dh, dlo, qr);  // dK += dS^T Q
          wgmma_commit();
        }
        wgmma_wait<0>();
        if constexpr (DK) fence_regs(ak);
        if constexpr (DV) fence_regs(av);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // epilogue: E (one split) or this split's f32 partial sums
  const size_t plane = (size_t)p.B * Sk * p.KH * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kr[hf];
    if (key >= Sk) continue;
    const size_t row = (((size_t)b * Sk + key) * p.KH + kh) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * hf;
      if (p.splits == 1) {
        if constexpr (DK)
          *reinterpret_cast<typename E::T2*>(static_cast<typename E::T*>(p.dk) +
                                             row + 8 * c) = E::pack(ak[i], ak[i + 1]);
        if constexpr (DV)
          *reinterpret_cast<typename E::T2*>(static_cast<typename E::T*>(p.dv) +
                                             row + 8 * c) = E::pack(av[i], av[i + 1]);
      } else {
        if constexpr (DK)
          *reinterpret_cast<float2*>(p.ws + sp * plane + row + 8 * c) =
              make_float2(ak[i], ak[i + 1]);
        if constexpr (DV)
          *reinterpret_cast<float2*>(p.ws + (p.splits + sp) * plane + row + 8 * c) =
              make_float2(av[i], av[i + 1]);
      }
    }
  }
}

template <class E, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ BwdArgs p) {
  using T = Dims<D>;
  constexpr int ST = dkv_stages<D>();
  constexpr int NKT = dkv_key_tiles<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = base;                 // NKT tiles
  uint8_t* sV = sK + NKT * T::TILE;   // NKT tiles
  uint8_t* sQ = sV + NKT * T::TILE;   // ST tiles
  uint8_t* sO = sQ + ST * T::TILE;    // dO, ST tiles
  float* sL = reinterpret_cast<float*>(sO + ST * T::TILE);  // ST x 64 lse2
  float* sD = sL + ST * BM;                                 // ST x 64 delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + ST * BM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int NS = p.splits;
  // the key tile is the slowest grid index: blocks start in index order,
  // so the lowest keys (the most causal work) of every (kv head, batch,
  // split) run first (GQA blocks walk H / KH heads each, and a tail of
  // them had left SMs idle)
  const int kh = blockIdx.x, b = blockIdx.y / NS, sp = blockIdx.y % NS;
  const int G = p.H / p.KH;
  const int Sq = p.Sq, Sk = p.Sk, off = Sk - Sq;
  const int kb = blockIdx.z * NKT * BN;
  // this split's query tiles [qs, qe)
  const int nq = (Sq + BM - 1) / BM;
  const int per = (nq + NS - 1) / NS;
  const int qs = min(nq, sp * per), qe = min(nq, qs + per);
  // the first query tile that sees key k0 (causal), within the split
  const auto first_q = [&](int k0) {
    if (k0 >= Sk) return qe;
    const int x = p.causal ? k0 - off : 0;
    return min(qe, max(qs, x <= 0 ? 0 : x / BM));
  };
  const int qlo = first_q(kb);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's 32 lanes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        uint32_t bytes = 0;
        for (int j = 0; j < NKT; ++j)
          if (kb + j * BN < Sk) bytes += 2 * T::DA * ATOM_BYTES;
        mbar_expect_tx(kv_full, bytes);
        for (int j = 0; j < NKT; ++j)
          if (kb + j * BN < Sk)
            for (int a = 0; a < T::DA; ++a) {
              tma_load_4d(sK + j * T::TILE + a * ATOM_BYTES, &p.tk, kv_full,
                          a * ATOM, kh, kb + j * BN, b);
              tma_load_4d(sV + j * T::TILE + a * ATOM_BYTES, &p.tv, kv_full,
                          a * ATOM, kh, kb + j * BN, b);
            }
      }
      int n = 0;
      for (int gh = 0; gh < G; ++gh) {
        const int h = kh * G + gh;
        const size_t at = ((size_t)b * p.H + h) * Sq;
        for (int it = qlo; it < qe; ++it, ++n) {
          const int st = n % ST;
          mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
          // lse (x log2 e) and delta of the tile's 64 queries, 0 past Sq
          for (int c = lane; c < BM; c += 32) {
            const int q = it * BM + c;
            sL[st * BM + c] = q < Sq ? p.lse[at + q] * LOG2E : 0.f;
            sD[st * BM + c] = q < Sq ? p.delta[at + q] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(&full[st], 2 * T::DA * ATOM_BYTES);
            for (int a = 0; a < T::DA; ++a) {
              tma_load_4d(sQ + st * T::TILE + a * ATOM_BYTES, &p.tq, &full[st],
                          a * ATOM, h, it * BM, b);
              tma_load_4d(sO + st * T::TILE + a * ATOM_BYTES, &p.tdo, &full[st],
                          a * ATOM, h, it * BM, b);
            }
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int j = NKT == 1 ? 0 : wg;  // this warpgroup's key tile
    const int k0 = kb + j * BN;
    const int qf = first_q(k0);
    const uint32_t ka = smem_u32(sK + j * T::TILE);
    const uint32_t va = smem_u32(sV + j * T::TILE);
    if (qf < qe) mbar_wait(kv_full, 0);
    if constexpr (NKT == 2) {
      dkv_consumer<E, D, true, true>(p, sQ, sO, sL, sD, full, empty, ka, va, k0, b,
                                  kh, sp, G, qlo, qf, qe, warp, lane);
    } else {
      if (wg == 0)
        dkv_consumer<E, D, false, true>(p, sQ, sO, sL, sD, full, empty, ka, va, k0,
                                     b, kh, sp, G, qlo, qf, qe, warp, lane);
      else
        dkv_consumer<E, D, true, false>(p, sQ, sO, sL, sD, full, empty, ka, va, k0,
                                     b, kh, sp, G, qlo, qf, qe, warp, lane);
    }
  }
}

// dk, dv = E of the NS partials [2, NS, n] summed in index order
template <class E>
__global__ void flash_bwd_dkv_reduce_kernel(const float* __restrict__ ws,
                                            typename E::T* __restrict__ dk,
                                            typename E::T* __restrict__ dv,
                                            size_t n, int ns) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < ns; ++s) {
      a = __fadd_rn(a, ws[s * n + e]);
      c = __fadd_rn(c, ws[(ns + s) * n + e]);
    }
    dk[e] = E::one(a);
    dv[e] = E::one(c);
  }
}

// ------------------------------------------------------------------ host
// Tensor maps of q and dout ([B, Sq, H, D], boxes of 64 rows of one head)
// and of k and v ([B, Sk, KH, D]); false when an encode fails.
template <class E>
inline bool bwd_maps(BwdArgs& a, const void* q, const void* k, const void* v,
                     const void* dout, int D) {
  const uint64_t row = (uint64_t)D * sizeof(typename E::T);
  const uint64_t sk = a.Sk > 0 ? a.Sk : 1;
  const int B = a.B, Sq = a.Sq, H = a.H, KH = a.KH;
  return make_map<E>(&a.tq, q, D, H, Sq, B, row, row * H, row * H * Sq, 1, BM, 1) &&
         make_map<E>(&a.tdo, dout, D, H, Sq, B, row, row * H, row * H * Sq, 1, BM, 1) &&
         make_map<E>(&a.tk, k, D, KH, sk, B, row, row * KH, row * KH * sk, 1, BN, 1) &&
         make_map<E>(&a.tv, v, D, KH, sk, B, row, row * KH, row * KH * sk, 1, BN, 1);
}

template <class E, int D>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_sm90_kernel<E, D>;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + 2 * BM - 1) / (2 * BM), a.H, a.B);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class E, int D>
cudaError_t launch_bwd_dkv(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_sm90_kernel<E, D>;
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int keys = dkv_key_tiles<D>() * BN;
  const dim3 grid(a.KH, a.B * a.splits, (a.Sk + keys - 1) / keys);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const size_t n = (size_t)a.B * a.Sk * a.KH * D;
  const int blocks = n / 256 + 1 < 4096 ? (int)(n / 256 + 1) : 4096;
  flash_bwd_dkv_reduce_kernel<E><<<blocks, 256, 0, stream>>>(
      a.ws, static_cast<typename E::T*>(a.dk), static_cast<typename E::T*>(a.dv),
      n, a.splits);
  return cudaGetLastError();
}

}  // namespace sm90
