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
// f32 keeps the simple FMA kernels (`flash_bwd_dq_fma`, `flash_bwd_dkdv_fma`):
// no main path runs the backward in f32 (the training stack computes in
// bf16), and TF32 tensor cores would miss the f32 tolerance of 1e-4.  The
// dtype picks the kernel; neither is a fallback for the other.  Their
// products are f32 FMAs out of shared memory, operands stored transposed and
// padded (stride 65) so that no warp hits one bank twice; the dK/dV block
// holds K^T, V^T, Q^T, g^T (4 x D x 65 f32) plus P and dS (2 x 64 x 65) —
// 163 KB at D = 128 — so the launch raises the dynamic shared-memory limit
// first and returns cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int BT = 64;          // rows per tile (queries and keys alike)
constexpr int NT = 256;         // 16 x 16 threads
constexpr int TS = BT + 1;      // padded stride of a transposed tile

// rows [r0, r0 + BT) of a (T, D) matrix into a transposed [D][TS] tile, times
// `mul`; rows past t read as 0
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* __restrict__ src, int r0,
                                       int t, float mul) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, d = i % D;
    const int gr = r0 + r;
    dst[d * TS + r] = gr < t ? src[(size_t)gr * D + d] * mul : 0.f;
  }
}

// Thread (tx, ty) = (tid % 16, tid / 16).  Of a 64 x 64 score tile it owns
// rows ty + 16*i and columns tx + 16*j (i, j < 4); of a 64 x D accumulator,
// rows ty + 16*i and columns tx + 16*c (c < D/16).

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int t, int causal, float sm_scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;               // [D][TS]  Q^T * scale
  float* gt = qt + D * TS;        // [D][TS]  g^T
  float* kt = gt + D * TS;        // [D][TS]  K^T
  float* vt = kt + D * TS;        // [D][TS]  V^T
  float* dst = vt + D * TS;       // [BT][TS] dS^T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * t * D;

  load_t<D>(qt, q + base, q0, t, sm_scale);
  load_t<D>(gt, g + base, q0, t, 1.f);

  float row_lse[4], row_delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < t ? lse[(size_t)bh * t + r] : 0.f;
    row_delta[i] = r < t ? delta[(size_t)bh * t + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (t + BT - 1) / BT;
  if (causal) n_kv = min(n_kv, q0 / BT + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // the previous tile's readers of kt / vt / dst are done
    load_t<D>(kt, k + base, k0, t, 1.f);
    load_t<D>(vt, v + base, k0, t, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], gg[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[d * TS + ty + 16 * i];
        gg[i] = gt[d * TS + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        b[jj] = kt[d * TS + tx + 16 * jj];
        vv[jj] = vt[d * TS + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
          dp[i][jj] = fmaf(gg[i], vv[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = k0 + tx + 16 * jj;
        const bool live = r < t && c < t && !(causal && c > r);
        const float p = live ? expf(s[i][jj] - row_lse[i]) : 0.f;
        dst[(tx + 16 * jj) * TS + ty + 16 * i] = p * (dp[i][jj] - row_delta[i]);
      }
    }
    __syncthreads();

    // dQ += dS K: K[key][col] is kt[col][key]
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dst[c * TS + ty + 16 * i];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kk = kt[(tx + 16 * cc) * TS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kk, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[base + (size_t)r * D + tx + 16 * c] = acc[i][c] * sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int t, int causal,
                   float sm_scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;               // [D][TS]  K^T (resident)
  float* vt = kt + D * TS;        // [D][TS]  V^T (resident)
  float* qt = vt + D * TS;        // [D][TS]  Q^T * scale (streamed)
  float* gt = qt + D * TS;        // [D][TS]  g^T (streamed)
  float* pt = gt + D * TS;        // [BT][TS] P, indexed [query][key]
  float* dst = pt + BT * TS;      // [BT][TS] dS, indexed [query][key]
  float* l_s = dst + BT * TS;     // [BT] lse of the query tile
  float* d_s = l_s + BT;          // [BT] delta of the query tile

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * t * D;

  load_t<D>(kt, k + base, k0, t, 1.f);
  load_t<D>(vt, v + base, k0, t, 1.f);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (t + BT - 1) / BT;
  const int first = causal ? k0 / BT : 0;   // query tiles above the diagonal see no key here

  for (int qi = first; qi < n_q; ++qi) {
    const int q0 = qi * BT;
    __syncthreads();  // the previous tile's readers of qt / gt / pt / dst are done
    load_t<D>(qt, q + base, q0, t, sm_scale);
    load_t<D>(gt, g + base, q0, t, 1.f);
    if (tid < BT) {
      const int r = q0 + tid;
      l_s[tid] = r < t ? lse[(size_t)bh * t + r] : 0.f;
      d_s[tid] = r < t ? delta[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T of the tile: keys ty + 16*i, queries tx + 16*jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], vv[4], b[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = kt[d * TS + ty + 16 * i];
        vv[i] = vt[d * TS + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        b[jj] = qt[d * TS + tx + 16 * jj];
        gg[jj] = gt[d * TS + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
          dp[i][jj] = fmaf(vv[i], gg[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;       // key
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qr = tx + 16 * jj;         // query, in the tile
        const int r = q0 + qr;
        const bool live = r < t && c < t && !(causal && c > r);
        const float p = live ? expf(s[i][jj] - l_s[qr]) : 0.f;
        pt[qr * TS + ty + 16 * i] = p;
        dst[qr * TS + ty + 16 * i] = p * (dp[i][jj] - d_s[qr]);
      }
    }
    __syncthreads();

    // dV += P^T g ; dK += dS^T (Q * scale): g[query][col] is gt[col][query]
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[r * TS + ty + 16 * i];
        ds[i] = dst[r * TS + ty + 16 * i];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float gg = gt[(tx + 16 * cc) * TS + r];
        const float qq = qt[(tx + 16 * cc) * TS + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][cc] = fmaf(p[i], gg, dv_acc[i][cc]);
          dk_acc[i][cc] = fmaf(ds[i], qq, dk_acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t o = base + (size_t)r * D + tx + 16 * c;
      dk[o] = dk_acc[i][c];
      dv[o] = dv_acc[i][c];
    }
  }
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dq, int bh, int t, int causal,
                  float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * TS + BT * TS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BT - 1) / BT, bh);
  flash_bwd_dq_fma<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dq), t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv_fma(const void* q, const void* k, const void* v, const void* g,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
                    int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * TS + 2 * BT * TS + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BT - 1) / BT, bh);
  flash_bwd_dkdv_fma<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), t, causal, sm_scale);
  return (int)cudaGetLastError();
}

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

#define DL4J_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

int dispatch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, void* dq, int bh, int t, int d, int causal, int is_bf16,
                float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                         \
  case DD:                                                                               \
    return is_bf16                                                                       \
               ? launch_dq_wgmma<DD>(q, k, v, g, lse, delta, dq, bh, t, causal, sm_scale, \
                                     s)                                                  \
               : launch_dq_fma<DD>(q, k, v, g, lse, delta, dq, bh, t, causal, sm_scale, s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkdv(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, void* dk, void* dv, int bh, int t, int d, int causal,
                  int is_bf16, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                            \
  case DD:                                                                                  \
    return is_bf16 ? launch_dkdv_wgmma<DD>(q, k, v, g, lse, delta, dk, dv, bh, t, causal,   \
                                           sm_scale, s)                                     \
                   : launch_dkdv_fma<DD>(q, k, v, g, lse, delta, dk, dv, bh, t, causal,     \
                                         sm_scale, s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bh rides in gridDim.x for the tensor-core kernels and in gridDim.y (at most
// 65535) for the FMA kernels; the wrapper holds both to 65535.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int bh, int t,
                                 int d, int causal, int is_bf16, float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  return dispatch_dq(q, k, v, g, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dq, bh, t, d, causal, is_bf16, sm_scale,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int t, int d, int causal, int is_bf16, float sm_scale,
                                   void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  return dispatch_dkdv(q, k, v, g, static_cast<const float*>(lse),
                       static_cast<const float*>(delta), dk, dv, bh, t, d, causal, is_bf16,
                       sm_scale, static_cast<cudaStream_t>(stream));
}
