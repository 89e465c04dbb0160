// flash_fwd.cu — FlashAttention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py `_fwd_kernel` (:35-92),
// launched there by `_flash_fwd_bhtd` (:95-138).  Same contract: q, k, v are
// (BH, T, D) in f32 or bf16; out has q's dtype; lse = m + log(l) is (BH, T) f32,
// stored plain (the TPU kernel's 8-sublane broadcast is a Mosaic layout only).
//
// What bounds it on the H100: operations.  The forward does two products of
// D multiply-adds for each (query, key) pair it visits (T(T+1)/2 a head when
// causal) on 3 * T * D inputs a head, far above the card's ~295 operations per
// byte, so the tensor cores and not HBM set the floor (bf16: 989 TFLOP/s).
//
// bf16 — every training step and every bf16 prefill — runs `flash_fwd_wgmma`,
// rounding where the Pallas kernel rounds with mxu_dtype = bf16: Q * scale is
// a bf16 operand of S = Q K^T and P a bf16 operand of P V; the running max,
// the normaliser l and every sum stay f32, and l sums the unrounded P.
//   - Work split: a block owns 128 query rows of one (b, h) and loops over
//     128-key K/V tiles, to the diagonal when causal.  It is three
//     warpgroups: a producer, whose one elected thread issues the TMA loads,
//     and two consumers of 64 query rows each; `setmaxnreg` moves registers
//     from the producer (24) to the consumers (240).  The grid launches the
//     last (heaviest causal) query tiles first.
//   - Copies: TMA with mbarriers.  Q once a block; K and V through a ring of
//     3 stages, each with a "full" barrier (the producer's expected bytes)
//     and an "empty" one (one arrival per consumer warp once its products on
//     that stage have retired).  No block-wide barrier in the loop.  The
//     tensor maps are 3-D (D, T, BH) with the swizzle that `Geo<D>` and the
//     wgmma descriptors name (128 B at D >= 64, 64 B at D 32, 32 B at D 16),
//     so a copy lands in the layout wgmma reads; rows past T read as zeros,
//     so ragged T needs no padding.  Inputs are contiguous and start on a
//     16-byte boundary (the wrapper checks both).  At D 128 a block holds 225 KB of shared memory (Q 32 KB, 3 x 64 KB of
//     K and V): one block an SM.
//   - Products: S = (Q * scale) K^T is wgmma m64n128k16 with both operands in
//     shared memory (Q * scale rounded to bf16 in place once, by the
//     consumer that owns the rows).  P leaves the S accumulators as the
//     register A fragment of O += P V (m64nNk16, V the MN-major B operand):
//     rounded to bf16 in pairs, it never touches shared memory.  The online
//     softmax runs in exp2 (one MUFU.EX2) with log2(e) folded into the
//     scores; each thread keeps its own partial row sums until the epilogue.
//     P is masked only on edge tiles (the diagonal, keys past T).
//   - Order: a consumer issues S_{j+1} = Q K_{j+1}^T and O += P_j V_j as two
//     groups, takes tile j+1's exponentials as soon as S_{j+1} is in (under
//     P_j V_j), then rescales O and packs P_{j+1} once P_j V_j has retired.
//     Ping-pong: two named barriers make the consumers take turns issuing
//     their products, so one's softmax runs under the other's products.
//   - Epilogue: O / l rounded to bf16 and lse = m + log(l), stored from
//     registers.
//
// f32 — the quantized path — keeps `flash_fwd_fma`, exact f32: a block of 256
// threads owns 64 query rows, loops over 64-key tiles to the diagonal and
// runs both products as f32 FMAs out of padded, transposed shared-memory
// tiles.  The dtype picks the kernel; neither is a fallback for the other.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int NT = 256;         // 16 x 16 threads
constexpr int QS = BQ + 1;      // padded strides of the transposed tiles
constexpr int KS = BK + 1;
constexpr float NEG = -1e30f;   // finite "-inf": exp() of it is an exact 0

// Thread (tx, ty) = (tid % 16, tid / 16) owns query rows ty + 16*i (i < 4)
// and, of the current KV tile, keys tx + 16*j (j < 4); of the output it owns
// columns tx + 16*c (c < D/16) of its four rows.
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int t, int causal, float sm_scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;               // [D][QS]  Q^T, pre-scaled
  float* kt = qt + D * QS;        // [D][KS]  K^T
  float* vs = kt + D * KS;        // [BK][D]  V
  float* pt = vs + BK * D;        // [BK][QS] P^T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * t * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qr = q0 + r;
    qt[d * QS + r] = qr < t ? q[base + (size_t)qr * D + d] * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (t + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of kt / vs / pt are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int kr = k0 + r;
      const bool ok = kr < t;
      kt[d * KS + r] = ok ? k[base + (size_t)kr * D + d] : 0.f;
      vs[r * D + d] = ok ? v[base + (size_t)kr * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * QS + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = kt[d * KS + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = k0 + tx + 16 * jj;
        if (c >= t || (causal && c > r)) s[i][jj] = NEG;
        mx = fmaxf(mx, s[i][jj]);
      }
      // the 16 threads that share row r are one half-warp (lane bit 4 = ty&1)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        s[i][jj] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) pt[(tx + 16 * jj) * QS + ty + 16 * i] = s[i][jj];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[c * QS + ty + 16 * i];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) out[base + (size_t)r * D + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[(size_t)bh * t + r] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int t, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D * QS + D * KS + BK * D + BK * QS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_fma<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int FWG = 128;            // threads of a warpgroup
constexpr int FROWS = 64;           // query rows of a consumer warpgroup
constexpr int FBQ = 2 * FROWS;      // query rows a block owns
constexpr int FBK = 128;            // keys a K/V tile
constexpr int NSTAGE = 3;           // K/V stages in flight
constexpr int FNT = 3 * FWG;        // producer + 2 consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BAR_Q = 1;            // named barriers 1, 2: a consumer's scaled Q is in place
constexpr int BAR_TURN = 3;         // 3, 4: consumer 0's, 1's turn to issue products
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit: one MUFU.EX2, subnormal results
// flushed to 0 (exp2f adds range handling around the same instruction)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// box (c0, c1, c2) of a 3-D tensor map into shared memory; completes bytes
// on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// One block per (bh, 128-row query tile).  Shared memory (1024-aligned):
// Q [128 rows], then NSTAGE x {K, V} [128 rows each], then the mbarriers.
template <int D>
__global__ void __launch_bounds__(FNT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                float* __restrict__ lse, int t, int causal, float sm_scale) {
  using G = Geo<D>;
  constexpr uint32_t QB = FBQ * D * 2, KB = FBK * D * 2;   // bytes of the Q, a K or a V tile
  constexpr uint32_t OQ = 0, OS = QB, STAGE = 2 * KB, OBAR = OS + NSTAGE * STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;   // swizzle atoms need 1024 B alignment
  uint8_t* sm = smem_raw + pad;
  const uint32_t sm_s = raw + pad;
  const uint32_t bar_q = sm_s + OBAR;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + NSTAGE + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FBQ;     // the heaviest tiles first
  const int tid = threadIdx.x, wg = tid / FWG;
  int n_kv = (t + FBK - 1) / FBK;
  if (causal) n_kv = min(n_kv, (min(q0 + FBQ, t) - 1) / FBK + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * FWG / 32);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bar_q, QB);
      for (int c = 0; c < G::CB; ++c)
        tma_load(sm_s + OQ + c * FBQ * G::RB, &tq, bar_q, c * G::NB, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % NSTAGE;
        if (j >= NSTAGE) mbar_wait(empty(s), (j / NSTAGE - 1) & 1);
        const uint32_t ks = sm_s + OS + s * STAGE, vs = ks + KB;
        mbar_expect_tx(full(s), 2 * KB);
        for (int c = 0; c < G::CB; ++c) {
          tma_load(ks + c * FBK * G::RB, &tk, full(s), c * G::NB, j * FBK, bh);
          tma_load(vs + c * FBK * G::RB, &tv, full(s), c * G::NB, j * FBK, bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wc = wg - 1;                                 // consumer 0 or 1
  const int ct = tid - wg * FWG, warp = ct / 32, lane = ct % 32;
  const int qw0 = q0 + wc * FROWS;                       // this consumer's first query
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = qw0 + 16 * warp + lane / 4 + 8 * h;

  // Q * scale rounded to bf16, in place, on this consumer's 64 rows
  mbar_wait(bar_q, 0);
  for (int i = ct; i < FROWS * G::CHUNKS; i += FWG) {
    uint4* p = reinterpret_cast<uint4*>(
        sm + OQ + G::offset(FBQ, wc * FROWS + i / G::CHUNKS, i % G::CHUNKS));
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * sm_scale, f.y * sm_scale);
    }
    *p = u;
  }
  fence_proxy_async();
  named_sync(BAR_Q + wc, FWG);

  float o[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[64];          // S of a tile; then, in place, its exponentials
  uint32_t pa[8][4];    // P rounded to bf16: the A fragments of its 8 k16 steps

  auto issue_s = [&](int j) {
    const uint32_t ks = sm_s + OS + (j % NSTAGE) * STAGE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n128(s, G::k_major(sm_s + OQ, FBQ, wc * FROWS, kk), G::k_major(ks, FBK, 0, kk),
                  kk > 0);
  };
  auto issue_pv = [&](int j) {
    const uint32_t vs = sm_s + OS + (j % NSTAGE) * STAGE + KB;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int c = 0; c < G::CB; ++c)
        MmaRs<G::NB>::run(o[c], pa[kk], G::mn_major(vs, FBK, kk, c));
  };
  // tile j's exponentials, in place in s, against the running max
  auto exponentials = [&](int j) {
    const int k0 = j * FBK;
    if ((causal && k0 + FBK - 1 > qw0) || k0 + FBK > t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2, h = (i % 4) / 2;
        if (key >= t || (causal && key > row[h])) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 threads of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * LOG2E);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i % 4) / 2;
      s[i] = exp2_approx(fmaf(s[i], LOG2E, -m[h]));
      l[h] += s[i];
    }
  };
  // once the previous P V has retired: O *= alpha, and P into bf16 A fragments
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int c = 0; c < G::CB; ++c)
#pragma unroll
      for (int i = 0; i < G::NB / 2; ++i) o[c][i] *= alpha[(i % 4) / 2];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  // ping-pong: consumer 0 issues first; consumer 1 skips its last arrival,
  // which consumer 0 would never wait for
  auto turn_begin = [&]() { named_sync(BAR_TURN + wc, 2 * FWG); };
  auto turn_end = [&](bool last) {
    if (!(wc == 1 && last)) named_arrive(BAR_TURN + 1 - wc, 2 * FWG);
  };

  if (wc == 1) named_arrive(BAR_TURN, 2 * FWG);
  mbar_wait(full(0), 0);
  turn_begin();
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  turn_end(false);
  wgmma_wait<0>();
  fence_regs(s);
  exponentials(0);
  rescale_and_pack();

  // every iteration but the last issues S_{j+1} and P_j V_j as two groups;
  // the group count is the same on every pass, so ptxas can keep the
  // products pipelined (a data-dependent group count serialises them)
  for (int j = 0; j + 1 < n_kv; ++j) {
    mbar_wait(full((j + 1) % NSTAGE), ((j + 1) / NSTAGE) & 1);
    turn_begin();
#pragma unroll
    for (int c = 0; c < G::CB; ++c) fence_regs(o[c]);
    wgmma_fence();
    issue_s(j + 1);
    wgmma_commit();
    issue_pv(j);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<1>();                    // S_{j+1} is in; P_j V_j may still run
    fence_regs(s);
    exponentials(j + 1);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int c = 0; c < G::CB; ++c) fence_regs(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % NSTAGE));    // this warp is done with stage j
    rescale_and_pack();
  }
  turn_begin();
#pragma unroll
  for (int c = 0; c < G::CB; ++c) fence_regs(o[c]);
  wgmma_fence();
  issue_pv(n_kv - 1);
  wgmma_commit();
  turn_end(true);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < G::CB; ++c) fence_regs(o[c]);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t base = (size_t)bh * t * D;
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int jn = 0; jn < G::NB / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= t) continue;
        const int col = c * G::NB + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(out + base + (size_t)row[h] * D + col) =
            pack_bf16(o[c][4 * jn + 2 * h] / l[h], o[c][4 * jn + 2 * h + 1] / l[h]);
      }
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < t) lse[(size_t)bh * t + row[h]] = m[h] * LN2 + logf(l[h]);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda link)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 3-D map (D, T, BH) of a contiguous bf16 (BH, T, D) tensor; a box is one
// column block of 128 rows of one head
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* base, int bh, int t) {
  using G = Geo<D>;
  static_assert(FBQ == FBK, "Q and K/V boxes share one row count");
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)t * D * 2};   // bytes
  const cuuint32_t box[3] = {(cuuint32_t)G::NB, (cuuint32_t)FBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
constexpr size_t wgmma_smem() {
  return 1024 + FBQ * D * 2 + NSTAGE * 2 * FBK * D * 2 + 8 * (1 + 2 * NSTAGE);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                 int t, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<D>(&mq, q, bh, t);
  if (err == cudaSuccess) err = make_map<D>(&mk, k, bh, t);
  if (err == cudaSuccess) err = make_map<D>(&mv, v, bh, t);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg only moves registers within the block's allocation: a block
  // launched with fewer than the two roles' total would wait forever
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma<D>);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  if (regs * FNT < PRODUCER_REGS * FWG + CONSUMER_REGS * 2 * FWG)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = wgmma_smem<D>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + FBQ - 1) / FBQ);
  flash_fwd_wgmma<D><<<grid, FNT, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int t,
             int d, int causal, int is_bf16, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                        \
  case DD:                                                                              \
    if (!is_bf16) return launch_fma<DD>(q, k, v, out, lse, bh, t, causal, sm_scale, s); \
    return launch_wgmma<DD>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    CASE(16) CASE(32) CASE(64) CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v contiguous (BH, T, D); bf16 ones 16-byte aligned.  bh rides in
// gridDim.x for the wgmma kernel and in gridDim.y (at most 65535) for the
// FMA kernel; the wrapper holds both to 65535.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, int bh, int t, int d, int causal, int is_bf16,
                              float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  return dispatch(q, k, v, out, static_cast<float*>(lse), bh, t, d, causal, is_bf16, sm_scale,
                  static_cast<cudaStream_t>(stream));
}
