// paged_attention.cu — one-query decode attention over a paged KV pool, for
// Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/ops/paged_attention.py `_pa_kernel`
// (:121-163), launched there by `_pallas_paged_attention` (:166-223), both
// variants: f32 pages, and int8 pages dequantised in-kernel with (P, ps, H)
// f32 per-(row, head) scales.  Contract of `_xla_paged_attention` (:94-116):
// q (S, H, Dh) f32; pools (P, ps, H, Dh); page_tbl (S, maxP) i32; seq_lens
// (S,) i32; out (S, H, Dh) f32; positions >= seq_len never contribute; a
// slot with seq_len 0 gets exact zeros.
//
// What bounds it on the H100: bytes.  Each live K/V element is read once and
// used for one multiply-add, so HBM bandwidth (3.35 TB/s) sets the floor; at
// int8 a page row costs a quarter of the bytes plus one f32 scale per head.
//
// What this design does about it: one thread block per (slot, head) reads
// its own page-table row and seq_len (the TPU kernel's scalar prefetch).
// Eight warps stride over the slot's live positions; a lane holds its
// share of q and of the accumulator, so one K or V row is one coalesced
// read by the warp.  Every head dim that is a multiple of 16 from 16 to
// 256 is instantiated: where 32 divides Dh a lane holds Dh/32 contiguous
// elements (one 16-byte load at Dh 128); otherwise (16, 48, 80, ...) a
// lane holds elements lane, lane + 32, ... and the lanes past the row's
// end of its last stride sit out, so no row is padded.  Each warp issues the K
// and V rows of 8 positions before it uses any of them, to keep many loads
// in flight, and keeps its own online softmax (running max, normaliser,
// accumulator in f32).  The eight partial softmaxes are merged once through
// shared memory.  Nothing is gathered into a dense copy and masked rows past
// seq_len are never read.  Not done yet: splitting one long slot across
// several blocks (flash-decoding), which a batch with one long stream needs
// to fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;           // warps per block
constexpr int U = 8;            // positions in flight per warp
constexpr float NEG = -1e30f;

// Which elements of a Dh-wide row lane `lane` holds: NE of them, element e
// at idx(lane, e), present where ok(lane, e).
template <int DH>
struct Lanes {
  static constexpr bool CONTIG = DH % 32 == 0;
  static constexpr int NE = CONTIG ? DH / 32 : DH / 32 + 1;
  static __device__ __forceinline__ int idx(int lane, int e) {
    return CONTIG ? lane * NE + e : e * 32 + lane;
  }
  static __device__ __forceinline__ bool ok(int lane, int e) {
    return CONTIG || e * 32 + lane < DH;
  }
};

// this lane's elements of the row at p (absent ones read as 0)
template <int DH>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int lane, float* dst) {
  using L = Lanes<DH>;
  if constexpr (L::CONTIG && L::NE % 4 == 0) {
#pragma unroll
    for (int e = 0; e < L::NE; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + L::idx(lane, e));
      dst[e] = x.x; dst[e + 1] = x.y; dst[e + 2] = x.z; dst[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < L::NE; ++e) dst[e] = L::ok(lane, e) ? p[L::idx(lane, e)] : 0.f;
  }
}

template <int DH>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ p, int lane, float* dst) {
  using L = Lanes<DH>;
  if constexpr (L::CONTIG && L::NE % 4 == 0) {
#pragma unroll
    for (int e = 0; e < L::NE; e += 4) {
      const char4 x = *reinterpret_cast<const char4*>(p + L::idx(lane, e));
      dst[e] = (float)x.x; dst[e + 1] = (float)x.y; dst[e + 2] = (float)x.z;
      dst[e + 3] = (float)x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < L::NE; ++e) dst[e] = L::ok(lane, e) ? (float)p[L::idx(lane, e)] : 0.f;
  }
}

template <typename KT, int DH, bool QUANT>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const float* __restrict__ q, const KT* __restrict__ kp,
                       const KT* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vsc, const int* __restrict__ tbl,
                       const int* __restrict__ lens, float* __restrict__ out,
                       int heads, int ps, int max_pages, float sm_scale) {
  using L = Lanes<DH>;
  constexpr int VPT = L::NE;
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][DH];

  const int s = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* o = out + ((size_t)s * heads + h) * DH;
  const int len = min(lens[s], max_pages * ps);
  if (len <= 0) {
    for (int i = threadIdx.x; i < DH; i += NW * 32) o[i] = 0.f;
    return;
  }
  const int* row_tbl = tbl + (size_t)s * max_pages;

  float qv[VPT];
  load_row<DH>(q + ((size_t)s * heads + h) * DH, lane, qv);

  float m = NEG, l = 0.f, acc[VPT];
#pragma unroll
  for (int e = 0; e < VPT; ++e) acc[e] = 0.f;

  for (int p0 = warp * U; p0 < len; p0 += NW * U) {
    float kv[U][VPT], vv[U][VPT], sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u;
      if (p < len) {
        const size_t rowi = (size_t)row_tbl[p / ps] * ps + (p % ps);
        const size_t off = (rowi * heads + h) * DH;
        load_row<DH>(kp + off, lane, kv[u]);
        load_row<DH>(vp + off, lane, vv[u]);
        if constexpr (QUANT) {
          const float a = ks[rowi * heads + h], b = vsc[rowi * heads + h];
#pragma unroll
          for (int e = 0; e < VPT; ++e) { kv[u][e] *= a; vv[u][e] *= b; }
        }
      } else {
#pragma unroll
        for (int e = 0; e < VPT; ++e) { kv[u][e] = 0.f; vv[u][e] = 0.f; }
      }
    }
    float mx = NEG;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; ++e) d = fmaf(qv[e], kv[u][e], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[u] = (p0 + u < len) ? d * sm_scale : NEG;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VPT; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = expf(sc[u] - m_new);
      l += pu;
#pragma unroll
      for (int e = 0; e < VPT; ++e) acc[e] = fmaf(pu, vv[u][e], acc[e]);
    }
    m = m_new;
  }

  if (lane == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
  for (int e = 0; e < VPT; ++e)
    if (L::ok(lane, e)) sm_acc[warp][L::idx(lane, e)] = acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < DH; i += NW * 32) {
    float big = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) big = fmaxf(big, sm_m[w]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w] - big);   // a warp with no positions: f = 0
      ll += sm_l[w] * f;
      aa += sm_acc[w][i] * f;
    }
    o[i] = aa / ll;
  }
}

template <typename KT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* tbl, const void* lens, void* out, int slots, int heads, int dh,
           int ps, int max_pages, float sm_scale, cudaStream_t stream) {
  const dim3 grid(slots, heads);
#define DL4J_PA_LAUNCH(D)                                                          \
  paged_attention_kernel<KT, D, QUANT><<<grid, NW * 32, 0, stream>>>(               \
      static_cast<const float*>(q), static_cast<const KT*>(kp),                    \
      static_cast<const KT*>(vp), static_cast<const float*>(ks),                   \
      static_cast<const float*>(vs), static_cast<const int*>(tbl),                 \
      static_cast<const int*>(lens), static_cast<float*>(out), heads, ps, max_pages, \
      sm_scale)
  switch (dh) {
#define DL4J_PA_CASE(D) \
  case D: DL4J_PA_LAUNCH(D); break;
    DL4J_PA_CASE(16) DL4J_PA_CASE(32) DL4J_PA_CASE(48) DL4J_PA_CASE(64)
    DL4J_PA_CASE(80) DL4J_PA_CASE(96) DL4J_PA_CASE(112) DL4J_PA_CASE(128)
    DL4J_PA_CASE(144) DL4J_PA_CASE(160) DL4J_PA_CASE(176) DL4J_PA_CASE(192)
    DL4J_PA_CASE(208) DL4J_PA_CASE(224) DL4J_PA_CASE(240) DL4J_PA_CASE(256)
#undef DL4J_PA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_PA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dl4j_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const void* page_tbl, const void* seq_lens, void* out,
                                    int slots, int heads, int head_dim, int num_pages,
                                    int page_size, int max_pages, int int8, float sm_scale,
                                    void* stream) {
  if (slots <= 0 || heads <= 0 || heads > 65535 || num_pages <= 0 || page_size <= 0 ||
      max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale, page_tbl, seq_lens,
                                out, slots, heads, head_dim, page_size, max_pages,
                                sm_scale, s);
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr, page_tbl, seq_lens,
                              out, slots, heads, head_dim, page_size, max_pages, sm_scale,
                              s);
}
