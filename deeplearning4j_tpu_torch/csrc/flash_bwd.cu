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
// What this design does about it, for now: it is the simple, correct version.
// The TPU runs its grid in order and carries dq (or dk, dv) in VMEM scratch
// across the innermost grid axis; Hopper blocks run in no order, so each block
// owns one 64-row tile and loops over the other axis itself, holding its
// accumulators in f32 registers.  No atomics: every output element has exactly
// one writer, so the result is the same bit for bit on every run.
//   - dQ kernel: one block per (bh, 64-row query tile); loops over KV tiles up
//     to the diagonal.
//   - dK/dV kernel: one block per (bh, 64-row key tile); K and V stay resident
//     in shared memory while Q and g stream through, from the diagonal tile
//     to the end.
// The products are f32 FMAs out of shared memory, operands stored transposed
// and padded (stride 65) so that no warp hits one bank twice on a read.  That
// runs at CUDA-core speed, far from the tensor-core bound: mma.sync, then
// wgmma + TMA, are the next steps.  Ragged T (prefill buckets such as 144 or
// 2000) is masked in-kernel: rows past T are read as 0, never stored, and their
// probabilities are exact zeros.
//
// Shared memory: the dK/dV block holds K^T, V^T, Q^T, g^T (4 x D x 65 f32) plus
// P^T and dS^T (2 x 64 x 65) — 163 KB at D = 128 — so the launch raises the
// dynamic shared-memory limit first and returns cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;          // rows per tile (queries and keys alike)
constexpr int NT = 256;         // 16 x 16 threads
constexpr int TS = BT + 1;      // padded stride of a transposed tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + BT) of a (T, D) matrix into a transposed [D][TS] tile, times
// `mul`; rows past t read as 0
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* __restrict__ src, int r0, int t,
                                       float mul) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, d = i % D;
    const int gr = r0 + r;
    dst[d * TS + r] = gr < t ? to_f32(src[(size_t)gr * D + d]) * mul : 0.f;
  }
}

// Thread (tx, ty) = (tid % 16, tid / 16).  Of a 64 x 64 score tile it owns
// rows ty + 16*i and columns tx + 16*j (i, j < 4); of a 64 x D accumulator,
// rows ty + 16*i and columns tx + 16*c (c < D/16).

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t, int causal, float sm_scale) {
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

  load_t<T, D>(qt, q + base, q0, t, sm_scale);
  load_t<T, D>(gt, g + base, q0, t, 1.f);

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
    load_t<T, D>(kt, k + base, k0, t, 1.f);
    load_t<T, D>(vt, v + base, k0, t, 1.f);
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
      dq[base + (size_t)r * D + tx + 16 * c] = from_f32<T>(acc[i][c] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int t, int causal,
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

  load_t<T, D>(kt, k + base, k0, t, 1.f);
  load_t<T, D>(vt, v + base, k0, t, 1.f);

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
    load_t<T, D>(qt, q + base, q0, t, sm_scale);
    load_t<T, D>(gt, g + base, q0, t, 1.f);
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
      dk[o] = from_f32<T>(dk_acc[i][c]);
      dv[o] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, void* dq, int bh, int t, int causal, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * TS + BT * TS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BT - 1) / BT, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dq), t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, void* dk, void* dv, int bh, int t, int causal,
                float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * TS + 2 * BT * TS + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BT - 1) / BT, bh);
  flash_bwd_dkdv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

#define DL4J_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, void* dq, int bh, int t, int d, int causal,
                float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD) \
  case DD: return launch_dq<T, DD>(q, k, v, g, lse, delta, dq, bh, t, causal, sm_scale, s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkdv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
                  int d, int causal, float sm_scale, cudaStream_t s) {
  switch (d) {
#define CASE(DD)                                                                      \
  case DD:                                                                            \
    return launch_dkdv<T, DD>(q, k, v, g, lse, delta, dk, dv, bh, t, causal, sm_scale, \
                              s);
    DL4J_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int bh, int t,
                                 int d, int causal, int bf16, float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return bf16 ? dispatch_dq<__nv_bfloat16>(q, k, v, g, l, dl, dq, bh, t, d, causal, sm_scale, s)
              : dispatch_dq<float>(q, k, v, g, l, dl, dq, bh, t, d, causal, sm_scale, s);
}

extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int t, int d, int causal, int bf16, float sm_scale,
                                   void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return bf16 ? dispatch_dkdv<__nv_bfloat16>(q, k, v, g, l, dl, dk, dv, bh, t, d, causal,
                                             sm_scale, s)
              : dispatch_dkdv<float>(q, k, v, g, l, dl, dk, dv, bh, t, d, causal, sm_scale, s);
}
