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
//     16-byte boundary (the wrapper checks both).  At D 128 a block holds
//     225 KB of shared memory (Q 32 KB, 3 x 64 KB of K and V): one block
//     an SM.
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
// f32 — the quantized path — runs `flash_fwd_split` on the same tensor cores
// at f32 accuracy: f32 inputs stay exact f32 (the Pallas kernel with
// mxu_f32 = True; ROADMAP C7), so every f32 operand is split into two bf16
// parts, a = a_hi + a_lo with a_hi = bf16(a) and a_lo = bf16(a - a_hi)
// (~16 significant bits together), and each product keeps three of the four
// part products, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, summed in the f32
// accumulators (the dropped a_lo b_lo is ~2^-16 of a b).
//   - A pre-pass kernel (`split_parts`, wgmma.cuh, shared with the f32
//     backward) writes Q * scale, K and V as hi and lo bf16 parts,
//     (3, 2, BH, T, D), into scratch the wrapper allocates;
//     so the f32 inputs need only be contiguous, and the main kernel reads
//     bf16 parts through TMA exactly as the bf16 kernel reads its inputs.
//   - Work split and roles as the bf16 kernel: 128 query rows a block, a
//     TMA producer warpgroup and two ping-pong consumers of 64 rows.  Twice
//     the bytes a key forces 64-key K/V tiles in a 2-stage ring (at D 128:
//     Q hi + lo 64 KB, a stage of K and V hi + lo 64 KB; 193 KB a block).
//   - S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T is three wgmma m64n64k16
//     with both operands in shared memory.  P, f32 in the S registers, is
//     split in registers into two bf16 A fragments, and
//     O += P_hi V_hi + P_hi V_lo + P_lo V_hi runs from registers against
//     the MN-major V tiles.  The running max, l (summing the unsplit P),
//     lse and the output scaling stay f32 as in the bf16 kernel.
//   - Bound: operations: three bf16 products a multiply-add on the
//     989 TFLOP/s tensor cores, where f32 FMAs would have 67 TFLOP/s.
// The dtype picks the kernel; neither is a fallback for the other.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

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
    mbar_init_fence();
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

template <int D>
constexpr size_t wgmma_smem() {
  return 1024 + FBQ * D * 2 + NSTAGE * 2 * FBK * D * 2 + 8 * (1 + 2 * NSTAGE);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                 int t, int causal, float sm_scale, cudaStream_t stream) {
  static_assert(FBQ == FBK, "Q and K/V boxes share one row count");
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_tile_map<D>(&mq, q, bh, t, FBQ);
  if (err == cudaSuccess) err = make_tile_map<D>(&mk, k, bh, t, FBK);
  if (err == cudaSuccess) err = make_tile_map<D>(&mv, v, bh, t, FBK);
  if (err == cudaSuccess)
    err = check_reg_budget(flash_fwd_wgmma<D>, FNT,
                           PRODUCER_REGS * FWG + CONSUMER_REGS * 2 * FWG);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = wgmma_smem<D>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + FBQ - 1) / FBQ);
  flash_fwd_wgmma<D><<<grid, FNT, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the same tensor cores on split bf16 parts
// ---------------------------------------------------------------------------

constexpr int SBK = 64;             // keys a K/V tile
constexpr int SSTAGE = 2;           // K/V stages in flight

// One block per (bh, 128-row query tile).  The maps read the parts as
// (D, T, 2 BH): head bh's hi part at bh, its lo part at BH + bh.  Shared
// memory (1024-aligned): Q hi, Q lo [128 rows each], then SSTAGE x
// {K hi, K lo, V hi, V lo} [64 rows each], then the mbarriers.
template <int D>
__global__ void __launch_bounds__(FNT, 1)
flash_fwd_split(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
                float* __restrict__ lse, int bh_total, int t, int causal) {
  using G = Geo<D>;
  constexpr uint32_t QB = FBQ * D * 2, KB = SBK * D * 2;   // bytes of a Q part, a K or V part
  constexpr uint32_t OS = 2 * QB, STAGE = 4 * KB, OBAR = OS + SSTAGE * STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sm_s = ((raw + 1023) & ~1023u);          // swizzle atoms need 1024 B alignment
  const uint32_t bar_q = sm_s + OBAR;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + SSTAGE + s); };
  // part p (0 hi, 1 lo) of K (0) or V (1) in stage s
  auto kv_tile = [&](int s, int which, int p) {
    return sm_s + OS + s * STAGE + (2 * which + p) * KB;
  };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FBQ;     // the heaviest tiles first
  const int tid = threadIdx.x, wg = tid / FWG;
  int n_kv = (t + SBK - 1) / SBK;
  if (causal) n_kv = min(n_kv, (min(q0 + FBQ, t) - 1) / SBK + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < SSTAGE; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * FWG / 32);                 // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * QB);
      for (int p = 0; p < 2; ++p)
        for (int c = 0; c < G::CB; ++c)
          tma_load(sm_s + p * QB + c * FBQ * G::RB, &tq, bar_q, c * G::NB, q0,
                   p * bh_total + bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % SSTAGE;
        if (j >= SSTAGE) mbar_wait(empty(s), (j / SSTAGE - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        for (int p = 0; p < 2; ++p)
          for (int c = 0; c < G::CB; ++c) {
            tma_load(kv_tile(s, 0, p) + c * SBK * G::RB, &tk, full(s), c * G::NB, j * SBK,
                     p * bh_total + bh);
            tma_load(kv_tile(s, 1, p) + c * SBK * G::RB, &tv, full(s), c * G::NB, j * SBK,
                     p * bh_total + bh);
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

  float o[G::CB][G::NB / 2];
#pragma unroll
  for (int c = 0; c < G::CB; ++c)
#pragma unroll
    for (int i = 0; i < G::NB / 2; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];             // S of a tile; then, in place, its exponentials
  uint32_t ph[4][4], pl[4][4];   // P's hi and lo parts: the A fragments of its 4 k16 steps

  auto issue_s = [&](int j) {
    const int st = j % SSTAGE;
    const uint32_t kh = kv_tile(st, 0, 0), kl = kv_tile(st, 0, 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qh = G::k_major(sm_s, FBQ, wc * FROWS, kk);
      const uint64_t ql = G::k_major(sm_s + QB, FBQ, wc * FROWS, kk);
      mma_ss_n64(s, qh, G::k_major(kh, SBK, 0, kk), kk > 0);
      mma_ss_n64(s, qh, G::k_major(kl, SBK, 0, kk), 1);
      mma_ss_n64(s, ql, G::k_major(kh, SBK, 0, kk), 1);
    }
  };
  auto issue_pv = [&](int j) {
    const int st = j % SSTAGE;
    const uint32_t vh = kv_tile(st, 1, 0), vl = kv_tile(st, 1, 1);
#pragma unroll
    for (int kk = 0; kk < SBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::CB; ++c) {
        MmaRs<G::NB>::run(o[c], ph[kk], G::mn_major(vh, SBK, kk, c));
        MmaRs<G::NB>::run(o[c], ph[kk], G::mn_major(vl, SBK, kk, c));
        MmaRs<G::NB>::run(o[c], pl[kk], G::mn_major(vh, SBK, kk, c));
      }
  };
  // tile j's exponentials, in place in s, against the running max
  auto exponentials = [&](int j) {
    const int k0 = j * SBK;
    if ((causal && k0 + SBK - 1 > qw0) || k0 + SBK > t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2, h = (i % 4) / 2;
        if (key >= t || (causal && key > row[h])) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
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
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      s[i] = exp2_approx(fmaf(s[i], LOG2E, -m[h]));
      l[h] += s[i];
    }
  };
  // once the previous P V has retired: O *= alpha, and P into hi / lo A fragments
  auto rescale_and_split = [&]() {
#pragma unroll
    for (int c = 0; c < G::CB; ++c)
#pragma unroll
      for (int i = 0; i < G::NB / 2; ++i) o[c][i] *= alpha[(i % 4) / 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);
  };
  // ping-pong, as in the bf16 kernel
  auto turn_begin = [&]() { named_sync(BAR_TURN + wc, 2 * FWG); };
  auto turn_end = [&](bool last) {
    if (!(wc == 1 && last)) named_arrive(BAR_TURN + 1 - wc, 2 * FWG);
  };

  mbar_wait(bar_q, 0);
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
  rescale_and_split();

  // every pass commits the same two groups (S_{j+1}, then P_j V_j), so
  // ptxas keeps the products pipelined
  for (int j = 0; j + 1 < n_kv; ++j) {
    mbar_wait(full((j + 1) % SSTAGE), ((j + 1) / SSTAGE) & 1);
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
    if (lane == 0) mbar_arrive(empty(j % SSTAGE));    // this warp is done with stage j
    rescale_and_split();
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
        *reinterpret_cast<float2*>(out + base + (size_t)row[h] * D + col) =
            make_float2(o[c][4 * jn + 2 * h] / l[h], o[c][4 * jn + 2 * h + 1] / l[h]);
      }
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < t) lse[(size_t)bh * t + row[h]] = m[h] * LN2 + logf(l[h]);
}

template <int D>
constexpr size_t split_smem() {
  return 1024 + 2 * FBQ * D * 2 + SSTAGE * 4 * SBK * D * 2 + 8 * (1 + 2 * SSTAGE);
}

// parts: (3, 2, bh, t, D) bf16 scratch, 16-byte aligned
template <int D>
int launch_split(const void* q, const void* k, const void* v, void* out, float* lse, void* parts,
                 int bh, int t, int causal, float sm_scale, cudaStream_t stream) {
  const size_t n = (size_t)bh * t * D;
  bf16* p = static_cast<bf16*>(parts);
  const SplitSrcs<3> src{{static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v)}};
  cudaError_t err = launch_split_parts<3>(src, p, n, sm_scale, stream);
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) err = make_tile_map<D>(&mq, p, 2 * bh, t, FBQ);
  if (err == cudaSuccess) err = make_tile_map<D>(&mk, p + 2 * n, 2 * bh, t, SBK);
  if (err == cudaSuccess) err = make_tile_map<D>(&mv, p + 4 * n, 2 * bh, t, SBK);
  if (err == cudaSuccess)
    err = check_reg_budget(flash_fwd_split<D>, FNT,
                           PRODUCER_REGS * FWG + CONSUMER_REGS * 2 * FWG);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = split_smem<D>();
  err = cudaFuncSetAttribute(flash_fwd_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + FBQ - 1) / FBQ);
  flash_fwd_split<D><<<grid, FNT, smem, stream>>>(mq, mk, mv, static_cast<float*>(out), lse, bh,
                                                  t, causal);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, void* parts,
             int bh, int t, int d, int causal, int is_bf16, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                           \
  case DD:                                                                                 \
    if (!is_bf16)                                                                          \
      return launch_split<DD>(q, k, v, out, lse, parts, bh, t, causal, sm_scale, s);       \
    return launch_wgmma<DD>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    CASE(16) CASE(32) CASE(64) CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v contiguous (BH, T, D); bf16 ones 16-byte aligned.  f32 ones take
// `parts`, (3, 2, BH, T, D) bf16 scratch from a 16-byte aligned start (bf16
// ignores it).  bh rides in gridDim.x; the wrapper holds it to 65535.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, void* parts, int bh, int t, int d, int causal,
                              int is_bf16, float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  return dispatch(q, k, v, out, static_cast<float*>(lse), parts, bh, t, d, causal, is_bf16,
                  sm_scale, static_cast<cudaStream_t>(stream));
}
