// dequant_matmul.cu — y = x @ (q * scale) for f32 activations against int8
// weights with per-output-channel f32 scales, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: deeplearning4j_tpu/ops/dequant_matmul.py `_dm_kernel` (:146-168),
// launched there by `_pallas_dequant_dot` (:171-212).  Contract of
// `_xla_dequant_dot` (:107-113): x (M, K) f32 row-major, q (K, N) int8
// row-major, scale (N,) f32 -> y (M, N) f32 with
//     y[m, n] = (sum_k x[m, k] * float(q[k, n])) * scale[n],
// the sum in f32 and the scale applied once, after the K loop, as the TPU
// kernel applies it at its last K block.
//
// What bounds it on the H100: operations, on the main path.  At M = 4096 rows
// every weight byte is used 2 * 4096 times; the f32 multiply-adds (67 TFLOP/s
// on CUDA cores) set the floor, not the 3.35 TB/s of HBM.  At decode-sized M
// (1 to 8 rows) the weight bytes set it instead.
//
// What this design does about it: each block of 256 threads owns one
// 128 x 128 output tile and loops over K in steps of 16 (the loop takes the
// place of the TPU's sequential K grid axis; Hopper blocks run in no order
// and carry nothing between them).  A K step stages an x slab (transposed,
// so a thread's rows are contiguous) and a q slab, converted to f32 once on
// its way into shared memory, so the int8 weights cross HBM at one byte
// each and are never written back as f32.  Each thread keeps an 8 x 8
// register tile of f32 sums (two 4-row by two 4-column groups, 64 apart, so
// the warp's 16-byte shared-memory reads are conflict-free) and does 64 FMAs
// for every 16 floats it reads from shared memory.  The next slab's global
// loads are issued into registers before the current slab is consumed, so
// their latency hides behind the FMAs.  M, N and K are masked at the ragged
// edge (out-of-range elements load as 0 and are never stored), so any shape
// runs: no (8, 128) tiling rule, no padding by the caller.  Not done yet:
// tensor cores (|q| <= 127 is exact in bf16), cp.async / TMA pipelines, and
// split-K for decode-sized M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int PAD = 4;   // keeps the transposed x stores off a 16-way bank conflict

__global__ void __launch_bounds__(THREADS, 2)
dequant_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y, int M,
                      int N, int K) {
  __shared__ __align__(16) float xs[BK][BM + PAD];   // x slab, transposed: xs[k][m]
  __shared__ __align__(16) float ws[BK][BN];         // q slab as f32: ws[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;            // 16 x 16 threads
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // global -> register mapping of one K step
  const int xk = tid % BK, xm = tid / BK;            // x: 8 rows (xm + 16 i), 1 column
  const int wn = tid % BN, wk = tid / BN;            // q: 8 rows (wk + 2 i), 1 column
  float xr[8], wr[8];

  auto fetch = [&](int k0) {
    const int k = k0 + xk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + xm + 16 * i;
      xr[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    const int n = n0 + wn;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = k0 + wk + 2 * i;
      wr[i] = (kk < K && n < N) ? (float)q[(size_t)kk * N + n] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[xk][xm + 16 * i] = xr[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[wk + 2 * i][wn] = wr[i];
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);                 // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  int cols[8];
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cols[j] = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    sc[j] = cols[j] < N ? scale[cols[j]] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    float* row = y + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (cols[j] < N) row[cols[j]] = acc[i][j] * sc[j];
  }
}

}  // namespace

extern "C" int dl4j_dequant_matmul(const void* x, const void* q, const void* scale, void* y,
                                   int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const int grid_m = (m + BM - 1) / BM;
  if (grid_m > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  const dim3 grid((n + BN - 1) / BN, grid_m);
  dequant_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), m, n, k);
  return (int)cudaGetLastError();
}
