// flash_fwd.cu — FlashAttention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py `_fwd_kernel` (:35-92),
// launched there by `_flash_fwd_bhtd` (:95-138).  Same contract: q, k, v are
// (BH, T, D) in f32 or bf16; out has q's dtype; lse = m + log(l) is (BH, T) f32,
// stored plain (the TPU kernel's 8-sublane broadcast is a Mosaic layout only).
//
// What bounds it on the H100: operations.  At the prefill shapes (T ~ 2000,
// D = 128) the causal forward does ~2*T*T*D multiply-adds per head and reads
// only 3*T*D inputs, far above the card's ~295 operations per byte, so the
// tensor cores and not HBM set the floor (bf16: 989 TFLOP/s).
//
// What this design does about it, for now: it is the simple, correct
// version.  Each thread block owns one 64-row query tile of one (b, h); an
// in-block loop over 64-row KV tiles replaces the TPU's sequential grid
// axis, keeps the running max m, the normaliser l and the output
// accumulator in f32 registers, and stops at the diagonal for causal
// attention (KV tiles above it are never loaded).  The products run as f32
// FMAs out of shared memory (Q and K stored transposed and padded so that
// no warp hits one bank twice), so the kernel runs at CUDA-core speed, far
// from the tensor-core bound; wgmma + TMA tiles are the next step.  The
// ragged last query / KV tile (prefill buckets are page multiples, e.g. 144
// or 2000) is masked in-kernel: rows past T are not stored, keys past T
// score -1e30 and contribute exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int NT = 256;         // 16 x 16 threads
constexpr int QS = BQ + 1;      // padded strides of the transposed tiles
constexpr int KS = BK + 1;
constexpr float NEG = -1e30f;   // finite "-inf": exp() of it is an exact 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns query rows ty + 16*i (i < 4)
// and, of the current KV tile, keys tx + 16*j (j < 4); of the output it owns
// columns tx + 16*c (c < D/16) of its four rows.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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
    qt[d * QS + r] = qr < t ? to_f32(q[base + (size_t)qr * D + d]) * sm_scale : 0.f;
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
      kt[d * KS + r] = ok ? to_f32(k[base + (size_t)kr * D + d]) : 0.f;
      vs[r * D + d] = ok ? to_f32(v[base + (size_t)kr * D + d]) : 0.f;
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
    for (int c = 0; c < DC; ++c)
      out[base + (size_t)r * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) lse[(size_t)bh * t + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int bh, int t, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D * QS + D * KS + BK * D + BK * QS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse,
               int bh, int t, int d, int causal, float sm_scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, t, causal, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, int bh, int t, int d, int causal, int bf16,
                              float sm_scale, void* stream) {
  if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, out, l, bh, t, d, causal, sm_scale, s)
              : dispatch_d<float>(q, k, v, out, l, bh, t, d, causal, sm_scale, s);
}
