// flash_bwd.cu — FlashAttention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py `_bwd_dq_kernel` (:141-186)
// and `_bwd_dkdv_kernel` (:189-239), both launched by `_flash_bwd_pallas`
// (:242-314).  Same contract: q, k, v, g (the output cotangent) are (BH, T, D)
// in f32 or bf16, one dtype; lse (the forward's logsumexp) and delta =
// rowsum(g * out) are plain (BH, T) f32 (the TPU kernels' 8-sublane broadcast
// is a Mosaic layout only).  dq, dk, dv take the inputs' dtype.
//
//   P  = exp(Q K^T * scale - lse)        recomputed, never stored
//   dP = g V^T ;  dS = P * (dP - delta)
//   dQ = dS K * scale ;  dK = dS^T (Q * scale) ;  dV = P^T g
//
// The scale is folded into Q once, as the Pallas kernels do (:161, :209): dQ
// carries one more factor of it, dK none (Q * scale already holds it).
//
// What bounds it on the H100: operations.  With pairs = BH * T(T+1)/2 causal
// (query, key) pairs, the dQ kernel does 3 products (S, dP, dS K) = 6*D*pairs
// operations and the dK/dV kernel 4 (S, dP, P^T g, dS^T Q) = 8*D*pairs, on
// 4*T*D inputs per head: far above the card's ~295 operations per byte, so the
// tensor cores set the floor (bf16: 989 TFLOP/s).
//
// bf16 — the training path — runs on the tensor cores (`flash_bwd_dq_wgmma`,
// `flash_bwd_dkdv_wgmma`), rounding where the Pallas kernels round with
// mxu_dtype = bf16: Q * scale, P and dS are bf16 operands of their products,
// every product sums in f32.
//   - Work split: a block is two warpgroups and owns 128 rows (queries for dQ,
//     keys for dK/dV), 64 a warpgroup; it loops over 64-row tiles of the other
//     axis, to the diagonal (dQ) or from it (dK/dV), with its sums in f32
//     registers.  Each output element has one writer, no atomics, so the bits
//     are the same on every run.  Blocks above the diagonal are never visited,
//     and the grid launches the heaviest row tiles first (the last query tiles
//     for dQ, the first key tiles for dK/dV), every head of one tile together.
//   - Products: every one is a `wgmma` m64nNk16, bf16 in, f32 out.  The block's
//     own rows are the A operand from shared memory for S and dP (Q and g for
//     dQ; K and V for dK/dV, which thus computes S^T and dP^T, keys as rows).
//     The streamed tile is the K-major B operand.  P (or P^T) and dS (or dS^T)
//     leave the f32 accumulators already laid out as wgmma's register A
//     fragment: they are rounded to bf16 in registers and never touch shared
//     memory.  The streamed tile then serves again as the MN-major (transposed)
//     B operand of dQ += dS K, dV += P^T g and dK += dS^T Q.
//   - Shared memory: bf16 tiles only, in the 128-byte-swizzled layout wgmma
//     reads without bank conflicts (64- and 32-byte swizzles for D = 32, 16).
//     The streamed tiles (K and V for dQ; Q, g, lse, delta for dK/dV) pass
//     through a ring of 2 stages filled by cp.async, so the next tile's copy
//     runs under this tile's products.  Rows past T are zero-filled by the
//     copy and masked out of P, so ragged T (prefill buckets such as 144 or
//     2000) needs no padding.  Q * scale is rounded to bf16 in place, by the
//     thread that copied each chunk.  128 KB a block at D = 128: one block, 8
//     warps, an SM.
//   - Not yet done: a producer warp with TMA, overlap of one warpgroup's
//     softmax with the other's products, and more than one block an SM.
//
// f32 — training with bf16_compute off, the JAX package's CPU arithmetic on
// the card — runs the same tensor cores at f32 accuracy (`flash_bwd_dq_split`,
// `flash_bwd_dkdv_split`), as the f32 forward does (flash_fwd.cu): f32 inputs
// stay exact f32 (the Pallas kernels with mxu_f32 = True; ROADMAP C7), so
// every f32 operand is split into two bf16 parts, a = a_hi + a_lo with
// a_hi = bf16(a), a_lo = bf16(a - a_hi), and every product keeps three of the
// four part products, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, summed in f32
// (the CPU emulation, tests/test_torch_split_precision.py, holds dQ, dK and
// dV within 1.6e-5 of max |exact| at T 2048, D 128; one part a side misses
// the 1e-4 tolerance by 30x and more, and TF32 keeps only 3 bits more).
//   - Pre-pass: `split_parts` (wgmma.cuh) writes Q * scale (the scale folded
//     in f32 first, as the plain version does), K, V and g as hi and lo bf16
//     parts, (4, 2, BH, T, D), into scratch the wrapper allocates, and
//     `split_delta` writes delta = rowsum(g * out) with g and out split as
//     dP = g V^T splits g and V, so that dP - delta, which cancels, carries
//     no error of the split where out = v.  The dQ call writes both and the
//     dK/dV call of the same backward reads them.  The f32 inputs need only
//     be contiguous.
//   - Work split: a block owns 128 rows, as in bf16, two warpgroups of 64.
//     Hi and lo parts double the bytes a row, so the block's own rows (4
//     tensors of parts, 128 rows: 128 KB at D 128) leave room for 32-row
//     streamed tiles only: a ring of 3 stages of 32 KB, each with a "full"
//     mbarrier (its TMA bytes).  225 KB a block at D 128, one block an SM.
//     TMA maps read the parts as (D, T, 2 BH), in the swizzle `Geo<D>`
//     names; rows past T read as zeros.
//   - Copies: thread 0 issues the own rows and the first 3 tiles; after
//     that the last of the 8 warps to finish with a stage (a count of
//     releases in shared memory) issues the tile that refills it, so no
//     thread waits for another.  There is no producer role: ptxas gives
//     every thread the registers of the block's largest role (setmaxnreg
//     does not change that), and only a 256-thread block leaves 255, which
//     the dK/dV consumer needs (dK and dV 128, the split P^T and dS^T
//     fragments 32, a fresh accumulator 32).  With a producer warp or
//     warpgroup (288 or 384 threads) ptxas gave 168 and both kernels
//     spilled at D 128.
//   - Products: S (or S^T) and dP (or dP^T) are three wgmma m64n32k16 a k16
//     step, both operands in shared memory; P = exp(S - lse) and
//     dS = P * (dP - delta) are computed in f32 from the unsplit accumulators
//     and split in registers into hi and lo A fragments; dQ += dS K,
//     dV += P^T g and dK += dS^T (Q * scale) run from registers against the
//     MN-major streamed tile, three part products each.  delta, lse and every
//     sum stay f32.
//   - Sums: each tile's dS K (and each column block's P^T g and dS^T Q) goes
//     into a fresh accumulator and is added to the running sum in f32
//     registers.  The tensor cores' own accumulation over a long chain of
//     products loses accuracy as the chain grows (dequant_matmul.cu met this
//     at K 4096); here a chain is 6 products deep, not up to 3 x T / 16.
//   - Bound: operations, three bf16 part products a multiply-add on the 989
//     TFLOP/s tensor cores, where the f32 FMAs of the kernels this replaced
//     had 67 TFLOP/s.
// The dtype picks the kernel; neither is a fallback for the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int WG = 128;             // threads of a warpgroup
constexpr int TILE = 64;            // rows of a warpgroup's tile and of a streamed tile
constexpr int NWG = 2;              // warpgroups a block
constexpr int WNT = NWG * WG;       // threads a block
constexpr int OWN = NWG * TILE;     // rows a block owns
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// rows [r0, r0 + rows) of a (T, D) bf16 matrix into a swizzled tile, by
// cp.async; rows past t are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* __restrict__ src, int r0,
                                          int rows, int t) {
  using G = Geo<D>;
  for (int i = threadIdx.x; i < rows * G::CHUNKS; i += WNT) {
    const int r = i / G::CHUNKS, cc = i % G::CHUNKS;
    const int gr = r0 + r;
    const bf16* p = src + (size_t)min(gr, t - 1) * D + cc * 8;
    cp_async16(tile + G::offset(rows, r, cc), p, gr < t);
  }
}

// Q * scale rounded to bf16, in place, on the chunks this thread copied with
// `load_tile` (the same i's, so its own cp.async writes are already visible)
template <int D>
__device__ __forceinline__ void scale_tile(uint8_t* tile, int rows, float scale) {
  using G = Geo<D>;
  for (int i = threadIdx.x; i < rows * G::CHUNKS; i += WNT) {
    uint4* p = reinterpret_cast<uint4*>(tile + G::offset(rows, i / G::CHUNKS, i % G::CHUNKS));
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = u;
  }
}

// dQ: one block per (bh, 128-row query tile); loops over 64-row K/V tiles.
template <int D>
__global__ void __launch_bounds__(WNT, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int t, int causal, float sm_scale) {
  using G = Geo<D>;
  constexpr uint32_t TB = TILE * D * 2;           // bytes of a 64-row tile
  constexpr uint32_t OQ = 0, OG = 2 * TB, OS = 4 * TB, STAGE = 2 * TB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;   // swizzle atoms need 1024 B alignment
  uint8_t* sm = smem_raw + pad;
  const uint32_t sm_s = raw + pad;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;     // the heaviest tiles first
  const int tid = threadIdx.x, wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  const int qw0 = q0 + wg * TILE;                        // this warpgroup's first query
  const size_t base = (size_t)bh * t * D;

  int n_kv = (t + TILE - 1) / TILE;
  if (causal) n_kv = min(n_kv, (min(q0 + OWN, t) - 1) / TILE + 1);

  load_tile<D>(sm_s + OQ, q + base, q0, OWN, t);
  load_tile<D>(sm_s + OG, g + base, q0, OWN, t);
  load_tile<D>(sm_s + OS, k + base, 0, TILE, t);
  load_tile<D>(sm_s + OS + TB, v + base, 0, TILE, t);
  cp_async_commit();

  // this thread's two query rows
  int row[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = qw0 + 16 * warp + lane / 4 + 8 * h;
    const bool in = row[h] < t;
    lse2[h] = in ? lse[(size_t)bh * t + row[h]] * LOG2E : 0.f;
    dl[h] = in ? delta[(size_t)bh * t + row[h]] : 0.f;
  }

  float acc[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const uint32_t nx = sm_s + OS + ((j + 1) & 1) * STAGE;
      load_tile<D>(nx, k + base, (j + 1) * TILE, TILE, t);
      load_tile<D>(nx + TB, v + base, (j + 1) * TILE, TILE, t);
    }
    cp_async_commit();
    cp_async_wait_1();                  // tile j (and, at j = 0, Q and g) has landed
    if (j == 0) scale_tile<D>(sm + OQ, OWN, sm_scale);
    fence_proxy_async();
    __syncthreads();

    const int k0 = j * TILE;
    const uint32_t ks = sm_s + OS + (j & 1) * STAGE, vs = ks + TB;
    if (!(causal && k0 > qw0 + TILE - 1)) {   // else every key is above this warpgroup's diagonal
      // S and dP as two groups: P's exponentials run under dP's products
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, G::k_major(sm_s + OQ, OWN, wg * TILE, kk), G::k_major(ks, TILE, 0, kk),
                   kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(dp, G::k_major(sm_s + OG, OWN, wg * TILE, kk), G::k_major(vs, TILE, 0, kk),
                   kk > 0);
      wgmma_commit();
      fence_regs(dp);
      wgmma_wait<1>();
      fence_regs(s);

      const bool edge = (causal && k0 + TILE - 1 > qw0) || k0 + TILE > t || qw0 + TILE > t;
#pragma unroll
      for (int i = 0; i < 32; ++i) {    // P, in place
        const int h = (i % 4) / 2;
        float p = exp2f(fmaf(s[i], LOG2E, -lse2[h]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (!(key < t && row[h] < t && !(causal && key > row[h]))) p = 0.f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS, rounded to bf16: elements 8 kk .. 8 kk + 7 are the A registers
      // of k16 step kk
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e, h = e % 2;
          a[kk][e] = pack_bf16(s[i] * (dp[i] - dl[h]), s[i + 1] * (dp[i + 1] - dl[h]));
        }

      // dQ += dS K: K-dim = the tile's keys, N = D
#pragma unroll
      for (int c = 0; c < G::CB; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < G::CB; ++c)
          MmaRs<G::NB>::run(acc[c], a[kk], G::mn_major(ks, TILE, kk, c));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::CB; ++c) fence_regs(acc[c]);
    }
    __syncthreads();                    // stage j & 1 is free for tile j + 2
  }

#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int jn = 0; jn < G::NB / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= t) continue;
        const int col = c * G::NB + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)row[h] * D + col) =
            pack_bf16(acc[c][4 * jn + 2 * h] * sm_scale, acc[c][4 * jn + 2 * h + 1] * sm_scale);
      }
}

// dK, dV: one block per (bh, 128-row key tile); loops over 64-row query tiles.
template <int D>
__global__ void __launch_bounds__(WNT, 1)
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int causal,
                     float sm_scale) {
  using G = Geo<D>;
  constexpr uint32_t TB = TILE * D * 2;
  // K, V resident; 2 stages of {Q * scale, g} (1024-aligned), then 2 of
  // {lse, delta}
  constexpr uint32_t OK = 0, OV = 2 * TB, OS = 4 * TB, STAGE = 2 * TB;
  constexpr uint32_t OL = 8 * TB, LSTAGE = 8 * TILE, LD = 4 * TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* sm = smem_raw + pad;
  const uint32_t sm_s = raw + pad;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * OWN;                       // the first (heaviest) tiles first
  const int tid = threadIdx.x, wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  const int kw0 = k0 + wg * TILE;
  const size_t base = (size_t)bh * t * D;
  const int n_q = (t + TILE - 1) / TILE;
  const int first = causal ? k0 / TILE : 0;

  auto load_stage = [&](int qi, int st) {
    const uint32_t s0 = sm_s + OS + st * STAGE;
    load_tile<D>(s0, q + base, qi * TILE, TILE, t);
    load_tile<D>(s0 + TB, g + base, qi * TILE, TILE, t);
    if (tid < 2 * TILE) {
      const int r = qi * TILE + tid % TILE;
      const float* src = (tid < TILE ? lse : delta) + (size_t)bh * t + min(r, t - 1);
      cp_async4(sm_s + OL + st * LSTAGE + (tid < TILE ? 0 : LD) + 4 * (tid % TILE), src,
                r < t);
    }
  };

  load_tile<D>(sm_s + OK, k + base, k0, OWN, t);
  load_tile<D>(sm_s + OV, v + base, k0, OWN, t);
  load_stage(first, 0);
  cp_async_commit();

  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = kw0 + 16 * warp + lane / 4 + 8 * h;

  float dka[G::CB][G::NB / 2], dva[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) dka[c][i] = dva[c][i] = 0.f;

  for (int qi = first, it = 0; qi < n_q; ++qi, ++it) {
    if (qi + 1 < n_q) load_stage(qi + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    scale_tile<D>(sm + OS + (it & 1) * STAGE, TILE, sm_scale);
    fence_proxy_async();
    __syncthreads();

    const int q0 = qi * TILE;
    const uint32_t qs = sm_s + OS + (it & 1) * STAGE, gs = qs + TB;
    if (!(causal && q0 + TILE - 1 < kw0)) {   // else every query is before this warpgroup's keys
      // S^T and dP^T in one group, then dV and dK in one: here one wait
      // each ran faster than waiting on S alone first (unlike dQ)
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, G::k_major(sm_s + OK, OWN, wg * TILE, kk), G::k_major(qs, TILE, 0, kk),
                   kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(dp, G::k_major(sm_s + OV, OWN, wg * TILE, kk), G::k_major(gs, TILE, 0, kk),
                   kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // S^T, dP^T: rows are keys, columns the tile's queries
      const float* ls = reinterpret_cast<const float*>(sm + OL + (it & 1) * LSTAGE);
      const float* dls = ls + TILE;
      const bool edge = (causal && q0 < kw0 + TILE - 1) || q0 + TILE > t || kw0 + TILE > t;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int qc = 8 * jn + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + qc);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          p[e] = exp2f(fmaf(s[i], LOG2E, -(e % 2 ? l2.y : l2.x) * LOG2E));
          if (edge) {
            const int qr = q0 + qc + e % 2, kr = key[e / 2];
            if (!(qr < t && kr < t && !(causal && kr > qr))) p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[i] - (e % 2 ? d2.y : d2.x));  // dS^T
        }
        // elements 4 jn + e of k16 step jn / 2 are its A registers 2 (jn % 2) + e / 2
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          pa[jn / 2][2 * (jn % 2) + e / 2] = pack_bf16(p[e], p[e + 1]);
          da[jn / 2][2 * (jn % 2) + e / 2] = pack_bf16(ds[e], ds[e + 1]);
        }
      }

      // dV += P^T g ; dK += dS^T (Q * scale): K-dim = the tile's queries, N = D
#pragma unroll
      for (int c = 0; c < G::CB; ++c) {
        fence_regs(dka[c]);
        fence_regs(dva[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < G::CB; ++c) {
          MmaRs<G::NB>::run(dva[c], pa[kk], G::mn_major(gs, TILE, kk, c));
          MmaRs<G::NB>::run(dka[c], da[kk], G::mn_major(qs, TILE, kk, c));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::CB; ++c) {
        fence_regs(dka[c]);
        fence_regs(dva[c]);
      }
    }
    __syncthreads();                    // stage it & 1 is free for the tile after next
  }

#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int jn = 0; jn < G::NB / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= t) continue;
        const size_t o = base + (size_t)key[h] * D + c * G::NB + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dka[c][4 * jn + 2 * h], dka[c][4 * jn + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) =
            pack_bf16(dva[c][4 * jn + 2 * h], dva[c][4 * jn + 2 * h + 1]);
      }
}

// shared memory of the tensor-core kernels: 4 tiles of 64 rows resident
// (2 x 128 rows), 2 stages of 2 tiles (+ lse, delta), and the alignment pad
template <int D>
constexpr size_t wgmma_smem(bool dkdv) {
  return 1024 + 8 * TILE * D * 2 + (dkdv ? 2 * 8 * TILE : 0);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* g,
                    const float* lse, const float* delta, void* dq, int bh, int t, int causal,
                    float sm_scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem<D>(false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + OWN - 1) / OWN);
  flash_bwd_dq_wgmma<D><<<grid, WNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dq), t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
                      int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem<D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + OWN - 1) / OWN);
  flash_bwd_dkdv_wgmma<D><<<grid, WNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      t, causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the same tensor cores on split bf16 parts
// ---------------------------------------------------------------------------

constexpr int SROWS = 64;           // rows of a consumer warpgroup
constexpr int SOWN = 2 * SROWS;     // rows a block owns
constexpr int SST = 32;             // rows of a streamed tile
constexpr int SSTAGE = 3;           // streamed tiles in flight
constexpr int SNT = 2 * WG;         // 2 warpgroups

// delta = rowsum(g * out) of f32 g and out, each split into two bf16 parts,
// as the kernels' three part products of dP = g V^T: g_hi o_hi + g_hi o_lo +
// g_lo o_hi, summed in f32 in a fixed order.  Where out = v (T = 1, the
// first query of a causal head) dP - delta then cancels exactly as in exact
// arithmetic, the split's own error with it.  One warp a row.
template <int D>
__global__ void split_delta(const float* __restrict__ g, const float* __restrict__ out,
                            float* __restrict__ delta, size_t rows) {
  const size_t row = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 32) {
    if (c + lane >= D) break;
    const float a = g[row * D + c + lane], b = out[row * D + c + lane];
    const float ah = __bfloat162float(__float2bfloat16(a));
    const float bh = __bfloat162float(__float2bfloat16(b));
    const float al = __bfloat162float(__float2bfloat16(a - ah));
    const float bl = __bfloat162float(__float2bfloat16(b - bh));
    sum += ah * bh + ah * bl + al * bh;
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) delta[row] = sum;
}

// Shared memory of the f32 kernels (1024-aligned): the block's own rows,
// parts (0 hi, 1 lo) of its two own tensors w (dQ: Q * scale, g; dK/dV: K,
// V), 128 rows each; then SSTAGE stages of the two streamed tensors' parts
// (dQ: K, V; dK/dV: Q * scale, g), 32 rows each; then the mbarriers (the
// own rows, and each stage's "full") and each stage's count of releases.
template <int D>
struct SplitSmem {
  static constexpr uint32_t OB = SOWN * D * 2, SB = SST * D * 2;   // an own, a streamed part
  static constexpr uint32_t OS = 4 * OB, STAGE = 4 * SB, OBAR = OS + SSTAGE * STAGE;
  static constexpr uint32_t OCNT = OBAR + 8 * (1 + SSTAGE);
  static constexpr size_t BYTES = 1024 + OCNT + 4 * SSTAGE;
  uint32_t base;     // shared-state-space address
  uint8_t* gen;      // the same byte, generic
  __device__ uint32_t own(int w, int p) const { return base + (2 * w + p) * OB; }
  __device__ uint32_t tile(int s, int w, int p) const {
    return base + OS + s * STAGE + (2 * w + p) * SB;
  }
  __device__ uint32_t bar_own() const { return base + OBAR; }
  __device__ uint32_t full(int s) const { return base + OBAR + 8 * (1 + s); }
  __device__ uint32_t* releases(int s) const {
    return reinterpret_cast<uint32_t*>(gen + OCNT) + s;
  }
  __device__ void init() const {
    mbar_init(bar_own(), 1);
    for (int s = 0; s < SSTAGE; ++s) {
      mbar_init(full(s), 1);
      *releases(s) = 0;
    }
    mbar_init_fence();
  }
};

template <int D>
__device__ __forceinline__ SplitSmem<D> split_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw), base = (a + 1023) & ~1023u;   // swizzle atoms: 1024 B
  return SplitSmem<D>{base, raw + (base - a)};
}

// The TMA loads, issued by one thread.  The maps read parts as (D, T, 2 BH):
// head bh's hi part at bh, its lo part at BH + bh.  Rows [row, row + 32) of
// streamed tensors c and d (hi and lo) into stage s:
template <int D>
__device__ __forceinline__ void load_tile(const SplitSmem<D>& sm, const CUtensorMap* c,
                                          const CUtensorMap* d, int row, int s, int bh,
                                          int bh_total) {
  using G = Geo<D>;
  mbar_expect_tx(sm.full(s), SplitSmem<D>::STAGE);
  for (int w = 0; w < 2; ++w)
    for (int p = 0; p < 2; ++p)
      for (int cb = 0; cb < G::CB; ++cb)
        tma_load(sm.tile(s, w, p) + cb * SST * G::RB, w ? d : c, sm.full(s), cb * G::NB, row,
                 p * bh_total + bh);
}

// the own rows [r0, r0 + 128) of tensors a and b once, and the first
// SSTAGE of the n streamed tiles, from row `first * 32` on
template <int D>
__device__ __forceinline__ void load_first(const SplitSmem<D>& sm, const CUtensorMap* a,
                                           const CUtensorMap* b, const CUtensorMap* c,
                                           const CUtensorMap* d, int r0, int first, int n,
                                           int bh, int bh_total) {
  using G = Geo<D>;
  mbar_expect_tx(sm.bar_own(), 4 * SplitSmem<D>::OB);
  for (int w = 0; w < 2; ++w)
    for (int p = 0; p < 2; ++p)
      for (int cb = 0; cb < G::CB; ++cb)
        tma_load(sm.own(w, p) + cb * SOWN * G::RB, w ? b : a, sm.bar_own(), cb * G::NB, r0,
                 p * bh_total + bh);
  for (int j = 0; j < SSTAGE && j < n; ++j)
    load_tile<D>(sm, c, d, (first + j) * SST, j, bh, bh_total);
}

// A consumer warp is done with streamed tile j (its products on the stage
// have retired): the last of the 8 warps to say so refills the stage with
// tile j + SSTAGE.  No thread waits for the others, and the warps that
// still run tile j's products are never held up.
template <int D>
__device__ __forceinline__ void release(const SplitSmem<D>& sm, const CUtensorMap* c,
                                        const CUtensorMap* d, int j, int first, int n, int bh,
                                        int bh_total, int lane) {
  __syncwarp();
  if (lane == 0) {
    const int s = j % SSTAGE;
    __threadfence_block();
    if (atomicAdd(sm.releases(s), 1u) % (SNT / 32) == SNT / 32 - 1 && j + SSTAGE < n) {
      __threadfence_block();
      load_tile<D>(sm, c, d, (first + j + SSTAGE) * SST, s, bh, bh_total);
    }
  }
  __syncwarp();
}

// d (+)= A B over the D columns as three part products a k16 step: A is the
// own rows [64 wc, 64 wc + 64) of own tensor w, B the tile's 32 rows of
// streamed tensor w (both K-major); the first product overwrites d
template <int D>
__device__ __forceinline__ void issue_split_ss(float (&d)[16], const SplitSmem<D>& sm, int w,
                                               int wc, int st) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t ah = G::k_major(sm.own(w, 0), SOWN, wc * SROWS, kk);
    const uint64_t al = G::k_major(sm.own(w, 1), SOWN, wc * SROWS, kk);
    const uint64_t bh = G::k_major(sm.tile(st, w, 0), SST, 0, kk);
    mma_ss_n32(d, ah, bh, kk > 0);
    mma_ss_n32(d, ah, G::k_major(sm.tile(st, w, 1), SST, 0, kk), 1);
    mma_ss_n32(d, al, bh, 1);
  }
}

// d = A B for column block c of the D columns: A the hi and lo fragments of
// the 32 streamed rows (2 k16 steps) in registers, B column block c of the
// tile's streamed tensor w (MN-major); three part products a k16 step
template <int D>
__device__ __forceinline__ void issue_split_rs(float (&d)[Geo<D>::NB / 2],
                                               const uint32_t (&hi)[2][4],
                                               const uint32_t (&lo)[2][4],
                                               const SplitSmem<D>& sm, int w, int st, int c) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < SST / 16; ++kk) {
    const uint64_t bh = G::mn_major(sm.tile(st, w, 0), SST, kk, c);
    MmaRs<G::NB>::run(d, hi[kk], bh, kk > 0);
    MmaRs<G::NB>::run(d, hi[kk], G::mn_major(sm.tile(st, w, 1), SST, kk, c));
    MmaRs<G::NB>::run(d, lo[kk], bh);
  }
}

// dQ: one block per (bh, 128-row query tile); loops over 32-row K/V tiles to
// the diagonal.
template <int D>
__global__ void __launch_bounds__(SNT, 1)
flash_bwd_dq_split(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int bh_total, int t, int causal, float sm_scale) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const SplitSmem<D> sm = split_smem<D>(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SOWN;    // the heaviest tiles first
  const int tid = threadIdx.x;
  int n_kv = (t + SST - 1) / SST;
  if (causal) n_kv = min(n_kv, (min(q0 + SOWN, t) - 1) / SST + 1);

  if (tid == 0) sm.init();
  __syncthreads();
  if (tid == 0) load_first<D>(sm, &tq, &tg, &tk, &tv, q0, 0, n_kv, bh, bh_total);
  __syncwarp();

  const int wc = tid / WG;                               // consumer 0 or 1
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int qw0 = q0 + wc * SROWS;                       // this consumer's first query
  int row[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = qw0 + 16 * warp + lane / 4 + 8 * h;
    const bool in = row[h] < t;
    lse2[h] = in ? lse[(size_t)bh * t + row[h]] * LOG2E : 0.f;
    dl[h] = in ? delta[(size_t)bh * t + row[h]] : 0.f;
  }
  float acc[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) acc[c][i] = 0.f;

  mbar_wait(sm.bar_own(), 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % SSTAGE, k0 = j * SST;
    mbar_wait(sm.full(st), (j / SSTAGE) & 1);
    if (!(causal && k0 > qw0 + SROWS - 1)) {   // else every key is above this consumer's diagonal
      // S = (Q * scale) K^T and dP = g V^T as two groups: P's exponentials
      // run under dP's products
      float s[16], dp[16];
      wgmma_fence();
      issue_split_ss<D>(s, sm, 0, wc, st);
      wgmma_commit();
      issue_split_ss<D>(dp, sm, 1, wc, st);
      wgmma_commit();
      fence_regs(dp);
      wgmma_wait<1>();
      fence_regs(s);
      const bool edge = (causal && k0 + SST - 1 > qw0) || k0 + SST > t || qw0 + SROWS > t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {    // P, in place
        const int h = (i % 4) / 2;
        float p = exp2f(fmaf(s[i], LOG2E, -lse2[h]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (!(key < t && row[h] < t && !(causal && key > row[h]))) p = 0.f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS in f32, split: elements 8 kk .. 8 kk + 7 are the A registers of
      // k16 step kk
      uint32_t dh[2][4], dlo[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e, h = e % 2;
          split_bf16(s[i] * (dp[i] - dl[h]), s[i + 1] * (dp[i + 1] - dl[h]), dh[kk][e],
                     dlo[kk][e]);
        }
      // this tile's dS K (K-dim = its keys, N = D), fresh, then added in f32
      float part[G::CB][G::NB / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < G::CB; ++c) issue_split_rs<D>(part[c], dh, dlo, sm, 0, st, c);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::CB; ++c) {
        fence_regs(part[c]);
#pragma unroll
        for (int i = 0; i < G::NB / 2; ++i) acc[c][i] += part[c][i];
      }
    }
    release<D>(sm, &tk, &tv, j, 0, n_kv, bh, bh_total, lane);
  }

#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int jn = 0; jn < G::NB / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= t) continue;
        const int col = c * G::NB + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<float2*>(dq + (size_t)bh * t * D + (size_t)row[h] * D + col) =
            make_float2(acc[c][4 * jn + 2 * h] * sm_scale, acc[c][4 * jn + 2 * h + 1] * sm_scale);
      }
}

// dK, dV: one block per (bh, 128-row key tile); loops over 32-row query tiles
// from the diagonal.
template <int D>
__global__ void __launch_bounds__(SNT, 1)
flash_bwd_dkdv_split(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tg, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int bh_total, int t, int causal) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const SplitSmem<D> sm = split_smem<D>(smem_raw);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * SOWN;                      // the first (heaviest) tiles first
  const int tid = threadIdx.x;
  const int first = causal ? k0 / SST : 0;               // query tiles before it see no key here
  const int n_q = (t + SST - 1) / SST - first;

  if (tid == 0) sm.init();
  __syncthreads();
  if (tid == 0) load_first<D>(sm, &tk, &tv, &tq, &tg, k0, first, n_q, bh, bh_total);
  __syncwarp();

  const int wc = tid / WG;
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int kw0 = k0 + wc * SROWS;                       // this consumer's first key
  const float* lse_h = lse + (size_t)bh * t;
  const float* delta_h = delta + (size_t)bh * t;
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = kw0 + 16 * warp + lane / 4 + 8 * h;
  float dka[G::CB][G::NB / 2], dva[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) dka[c][i] = dva[c][i] = 0.f;

  mbar_wait(sm.bar_own(), 0);
  for (int it = 0; it < n_q; ++it) {
    const int st = it % SSTAGE, q0 = (first + it) * SST;
    mbar_wait(sm.full(st), (it / SSTAGE) & 1);
    if (!(causal && q0 + SST - 1 < kw0)) {   // else every query is before this consumer's keys
      // S^T = K (Q * scale)^T and dP^T = V g^T: rows are keys, columns the
      // tile's queries
      float s[16], dp[16];
      wgmma_fence();
      issue_split_ss<D>(s, sm, 0, wc, st);
      issue_split_ss<D>(dp, sm, 1, wc, st);
      wgmma_commit();
      // lse and delta of this thread's query columns 8 jn + 2 (lane % 4) + x,
      // loaded under the products
      float l2[8], dd[8];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int qr = q0 + 8 * jn + 2 * (lane % 4) + x;
          l2[2 * jn + x] = qr < t ? lse_h[qr] * LOG2E : 0.f;
          dd[2 * jn + x] = qr < t ? delta_h[qr] : 0.f;
        }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = (causal && q0 < kw0 + SROWS - 1) || q0 + SST > t || kw0 + SROWS > t;
      // P^T and dS^T in f32, split: elements 4 jn + e of k16 step jn / 2 are
      // its A registers 2 (jn % 2) + e / 2
      uint32_t ph[2][4], pl[2][4], dh[2][4], dlo[2][4];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e, x = e % 2;
          p[e] = exp2f(fmaf(s[i], LOG2E, -l2[2 * jn + x]));
          if (edge) {
            const int qr = q0 + 8 * jn + 2 * (lane % 4) + x, kr = key[e / 2];
            if (!(qr < t && kr < t && !(causal && kr > qr))) p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[i] - dd[2 * jn + x]);
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = 2 * (jn % 2) + e / 2;
          split_bf16(p[e], p[e + 1], ph[jn / 2][r], pl[jn / 2][r]);
          split_bf16(ds[e], ds[e + 1], dh[jn / 2][r], dlo[jn / 2][r]);
        }
      }
      // dV += P^T g and dK += dS^T (Q * scale), a column block at a time:
      // each into a fresh accumulator, then added in f32
#pragma unroll
      for (int c = 0; c < G::CB; ++c) {
        float part[G::NB / 2];
        wgmma_fence();
        issue_split_rs<D>(part, ph, pl, sm, 1, st, c);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < G::NB / 2; ++i) dva[c][i] += part[i];
        wgmma_fence();
        issue_split_rs<D>(part, dh, dlo, sm, 0, st, c);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < G::NB / 2; ++i) dka[c][i] += part[i];
      }
    }
    release<D>(sm, &tq, &tg, it, first, n_q, bh, bh_total, lane);
  }

#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int jn = 0; jn < G::NB / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= t) continue;
        const size_t o =
            (size_t)bh * t * D + (size_t)key[h] * D + c * G::NB + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<float2*>(dk + o) =
            make_float2(dka[c][4 * jn + 2 * h], dka[c][4 * jn + 2 * h + 1]);
        *reinterpret_cast<float2*>(dv + o) =
            make_float2(dva[c][4 * jn + 2 * h], dva[c][4 * jn + 2 * h + 1]);
      }
}

// parts: (4, 2, bh, t, D) bf16 scratch, 16-byte aligned, for Q * scale, K, V
// and g in that order.  Given the forward's `out`, the call first writes
// them, and delta (`split_delta`); else both hold what an earlier call
// wrote.  own_* / str_* index the four tensors.
template <int D, typename K>
cudaError_t prepare_split(K kernel, const void* q, const void* k, const void* v, const void* g,
                          const void* out, float* delta, void* parts, int bh, int t,
                          float sm_scale, int own_a, int own_b, int str_a, int str_b,
                          CUtensorMap (&maps)[4], cudaStream_t stream) {
  const size_t n = (size_t)bh * t * D, rows = (size_t)bh * t;
  bf16* p = static_cast<bf16*>(parts);
  cudaError_t err = cudaSuccess;
  if (out != nullptr) {
    const SplitSrcs<4> src{{static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const float*>(g)}};
    err = launch_split_parts<4>(src, p, n, sm_scale, stream);
    if (err == cudaSuccess) {
      split_delta<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
          static_cast<const float*>(g), static_cast<const float*>(out), delta, rows);
      err = cudaGetLastError();
    }
  }
  const int which[4] = {own_a, own_b, str_a, str_b};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_tile_map<D>(&maps[i], p + 2 * which[i] * n, 2 * bh, t, i < 2 ? SOWN : SST);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SplitSmem<D>::BYTES);
  return err;
}

template <int D>
int launch_dq_split(const void* q, const void* k, const void* v, const void* g, const void* out,
                    const float* lse, float* delta, void* dq, void* parts, int bh, int t,
                    int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap m[4];   // own Q * scale, g; streamed K, V
  const cudaError_t err = prepare_split<D>(flash_bwd_dq_split<D>, q, k, v, g, out, delta, parts,
                                           bh, t, sm_scale, 0, 3, 1, 2, m, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + SOWN - 1) / SOWN);
  flash_bwd_dq_split<D><<<grid, SNT, SplitSmem<D>::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<float*>(dq), bh, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv_split(const void* q, const void* k, const void* v, const void* g,
                      const void* out, const float* lse, float* delta, void* dk, void* dv,
                      void* parts, int bh, int t, int causal, float sm_scale,
                      cudaStream_t stream) {
  CUtensorMap m[4];   // own K, V; streamed Q * scale, g
  const cudaError_t err = prepare_split<D>(flash_bwd_dkdv_split<D>, q, k, v, g, out, delta,
                                           parts, bh, t, sm_scale, 1, 2, 0, 3, m, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + SOWN - 1) / SOWN);
  flash_bwd_dkdv_split<D><<<grid, SNT, SplitSmem<D>::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), bh,
      t, causal);
  return (int)cudaGetLastError();
}

#define DL4J_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

int dispatch_dq(const void* q, const void* k, const void* v, const void* g, const void* out,
                const float* lse, float* delta, void* dq, void* parts, int bh, int t, int d,
                int causal, int is_bf16, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                          \
  case DD:                                                                                \
    return is_bf16 ? launch_dq_wgmma<DD>(q, k, v, g, lse, delta, dq, bh, t, causal,      \
                                         sm_scale, s)                                     \
                   : launch_dq_split<DD>(q, k, v, g, out, lse, delta, dq, parts, bh, t,   \
                                         causal, sm_scale, s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkdv(const void* q, const void* k, const void* v, const void* g, const void* out,
                  const float* lse, float* delta, void* dk, void* dv, void* parts, int bh, int t,
                  int d, int causal, int is_bf16, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                              \
  case DD:                                                                                    \
    return is_bf16 ? launch_dkdv_wgmma<DD>(q, k, v, g, lse, delta, dk, dv, bh, t, causal,     \
                                           sm_scale, s)                                       \
                   : launch_dkdv_split<DD>(q, k, v, g, out, lse, delta, dk, dv, parts, bh, t, \
                                           causal, sm_scale, s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bh rides in gridDim.x; the wrapper holds it to 65535.  bf16 reads delta
// (rowsum(g * out), f32) and ignores `out` and `parts`.  f32 goes through
// `parts`, (4, 2, BH, T, D) bf16 scratch from a 16-byte aligned start, and
// `delta`, (BH, T) f32: given the forward's `out`, the call first writes Q *
// scale, K, V and g there as hi and lo parts, and delta from g and out split
// the same way; with `out` null it reads what an earlier call on the same
// stream wrote (the wrapper's dQ call writes them, its dK/dV call reads them).
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* out, const void* lse, void* delta, void* dq,
                                 void* parts, int bh, int t, int d, int causal, int is_bf16,
                                 float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535 || (!is_bf16 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  return dispatch_dq(q, k, v, g, out, static_cast<const float*>(lse), static_cast<float*>(delta),
                     dq, parts, bh, t, d, causal, is_bf16, sm_scale,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                                   const void* out, const void* lse, void* delta, void* dk,
                                   void* dv, void* parts, int bh, int t, int d, int causal,
                                   int is_bf16, float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535 || (!is_bf16 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  return dispatch_dkdv(q, k, v, g, out, static_cast<const float*>(lse),
                       static_cast<float*>(delta), dk, dv, parts, bh, t, d, causal, is_bf16,
                       sm_scale, static_cast<cudaStream_t>(stream));
}
