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
// kernel applies it at its last K block.  The int8 weights cross HBM as int8
// on both routes and are widened only on chip, never written back wider.
//
// Two routes; the wrapper (ops/dequant_matmul.py) picks one by shape.
//
// `dequant_matmul_wgmma` — more than 64 rows (the quantized `output()` runs
// M = 4096).  Bound: operations.  At M 4096 every weight byte is used 2 * 4096
// times, so the multiply-adds and not HBM set the floor; on the CUDA cores
// (67 TFLOP/s f32) that floor was 4-8x the tensor cores'.  This route keeps
// f32 accuracy on the bf16 tensor cores (989 TFLOP/s):
//   - |q| <= 128 is exact in bf16, so the weight needs no split; x is split
//     into two bf16 parts, x = x_hi + x_lo, x_hi = bf16(x), x_lo =
//     bf16(x - x_hi) (~16 significant bits together; a third part would
//     carry all 24, but two hold the 1e-5 / 2e-5 tolerances with room, by
//     the CPU emulation in tests/test_torch_split_precision.py), and
//     y = x_hi q + x_lo q sums in the f32 accumulators, the scale in the
//     epilogue.  A pre-pass kernel (`split_x`) writes the parts, (2, M, KP)
//     with KP = K rounded up to 8 and zeros past K, into scratch the wrapper
//     allocates: 8 bytes out for every 4 in.
//   - A block owns a 128 x 128 output tile and is three warpgroups.  The
//     producer warpgroup's first warp issues TMA loads into a 4-stage
//     mbarrier ring, each stage a 64-deep K slab: x_hi and x_lo (128 x 64
//     bf16, 128-byte swizzle) and q (64 x 128 int8, 128-byte swizzle).  Its
//     other three warps convert: wgmma reads its B operand only from
//     shared memory and only as bf16, so they widen each int8 slab into one
//     of two bf16 B buffers (MN-major, `Geo<128>`), exactly (int8 -> f32
//     through the 2^23 magic number, then the top half of the f32), and
//     arrive on that buffer's barrier.  This was taken over the transposed
//     product (y^T = q^T x^T with q as the register A operand), which would
//     widen q in registers but read each int8 byte of a fragment
//     separately, through a tile whose columns are the fragment's rows.
//   - Two consumer warpgroups own 64 rows each and run, per slab, 4 k16
//     steps x 2 parts of wgmma m64n128k16 (A = x part, K-major; B = the
//     widened q, MN-major) into a fresh 64-register accumulator, then add
//     it to the running f32 sum in registers.  On the card, a first design
//     that let the tensor cores accumulate over all of K (512 chained k16
//     steps at K 4096) missed the split's own error by several times, and
//     by more as K grew; a slab chains 8.  The two consumers take turns on
//     the tensor cores while each adds its slab.  Stages and B buffers are
//     released by mbarrier arrivals, with no block-wide barrier in the
//     loop.
//     Epilogue: the sum times scale[n], stored from registers.
//   - TMA needs N % 16 == 0 (q's row stride) and a 16-byte aligned q; ragged
//     M and N and any K are masked by TMA's zero fill and the epilogue.
//
// `dequant_matmul_rows` — up to 64 rows (decode-sized products), or shapes
// TMA cannot describe.  Bound: the weight bytes (at M 1 a weight byte is
// used twice).  Exact f32 FMAs on the CUDA cores: a warp owns up to 4 rows
// of x (1, 2 or 4, the fewest that cover M) and a 512-column strip of q,
// each lane 16 columns (one 16-byte load a K row; the next 8 K rows of q
// and of x in flight while 8 are summed; q widened by `widen4`), over one
// K range; the wrapper splits K so the grid puts every SM on the weight
// bytes, and a second pass (`dequant_matmul_reduce`) sums the splits in a
// fixed order and applies the scale: one writer an element, no atomics,
// the same bits every launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// large M: split x, then bf16 wgmma
// ---------------------------------------------------------------------------

constexpr int WGT = 128;                       // threads of a warpgroup
constexpr int BM = 128, BN = 128, BK = 64;     // block tile, K slab
constexpr int STAGES = 4;
constexpr int THREADS = 3 * WGT;               // producer / converters + 2 consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t A_BYTES = BM * BK * 2;      // one x part of a slab
constexpr uint32_t Q_BYTES = BK * BN;          // an int8 slab
constexpr uint32_t STAGE_BYTES = 2 * A_BYTES + Q_BYTES;
constexpr uint32_t B_BYTES = BK * BN * 2;      // a widened slab
constexpr uint32_t OFF_B = STAGES * STAGE_BYTES;
constexpr uint32_t OFF_BAR = OFF_B + 2 * B_BYTES;
constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (2 * STAGES + 4);

// x (m, k) f32 -> parts (2, m, kp) bf16, hi then lo, zeros past k; a thread
// writes 8 columns of one row of each part
__global__ void split_x(const float* __restrict__ x, bf16* __restrict__ parts, int m, int k,
                        int kp) {
  const int groups = kp / 8;
  const size_t total = (size_t)m * groups;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / groups), c0 = 8 * (int)(i % groups);
    const float* src = x + (size_t)r * k;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      split_bf16(c < k ? src[c] : 0.f, c + 1 < k ? src[c + 1] : 0.f, hi[e], lo[e]);
    }
    const size_t o = (size_t)r * kp + c0;
    *reinterpret_cast<uint4*>(parts + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(parts + (size_t)m * kp + o) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// four int8 -> four f32, exactly: int8 b becomes the f32 2^23 + (b ^ 0x80)
// (one PRMT), and minus 2^23 + 128 (one FADD) that is b
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  w ^= 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b)) - 8388736.f;
}

// 16 int8 -> 16 bf16, exactly: |b| <= 128 has at most 8 significant bits,
// so the top half of `widen4`'s f32 is b in bf16
__device__ __forceinline__ void widen16(uint4 in, uint4& lo8, uint4& hi8) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4(w[i], f);
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo8 = make_uint4(o[0], o[1], o[2], o[3]);
  hi8 = make_uint4(o[4], o[5], o[6], o[7]);
}

// One block per 128 x 128 output tile.  tx: the x parts as (kp, m, 2) bf16;
// tq: q as (n, k, 1) int8.
__global__ void __launch_bounds__(THREADS, 1)
dequant_matmul_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tq, const float* __restrict__ scale,
                     float* __restrict__ y, int m, int n, int kp) {
  using GB = Geo<BN>;                          // a widened slab: 64 rows (K) x 128 (N)
  using GA = Geo<BK>;                          // an x part: 128 rows (M) x 64 (K)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;    // swizzle atoms need 1024 B alignment
  uint8_t* sm = smem_raw + pad;
  const uint32_t sm_s = raw + pad;
  const uint32_t bar0 = sm_s + OFF_BAR;
  auto full = [&](int s) { return bar0 + 8 * s; };                    // TMA bytes landed
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };        // consumers done
  auto bfull = [&](int b) { return bar0 + 8 * (2 * STAGES + b); };    // converters done
  auto bempty = [&](int b) { return bar0 + 8 * (2 * STAGES + 2 + b); };
  auto a_tile = [&](int s, int p) { return sm_s + s * STAGE_BYTES + p * A_BYTES; };
  auto q_off = [&](int s) { return s * STAGE_BYTES + 2 * A_BYTES; };

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_k = (kp + BK - 1) / BK;
  const int tid = threadIdx.x, wg = tid / WGT, warp = (tid % WGT) / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WGT / 32);       // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bfull(b), 3);                  // one arrival per converter warp
      mbar_init(bempty(b), 2 * WGT / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 0) {
      // producer: one thread keeps the ring full
      if (lane == 0) {
        for (int j = 0; j < n_k; ++j) {
          const int s = j % STAGES;
          if (j >= STAGES) mbar_wait(empty(s), (j / STAGES - 1) & 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load(a_tile(s, 0), &tx, full(s), j * BK, m0, 0);
          tma_load(a_tile(s, 1), &tx, full(s), j * BK, m0, 1);
          tma_load(sm_s + q_off(s), &tq, full(s), n0, j * BK, 0);
        }
      }
      return;
    }
    // converters: warps 1-3 widen each int8 slab into a bf16 B buffer.  A
    // warp step takes 8 rows (one a lane, so the swizzled reads and writes
    // spread over all banks) x 4 sixteen-column chunks.
    for (int j = 0; j < n_k; ++j) {
      const int s = j % STAGES, b = j % 2;
      mbar_wait(full(s), (j / STAGES) & 1);
      if (j >= 2) mbar_wait(bempty(b), (j / 2 - 1) & 1);
      const uint8_t* qs = sm + q_off(s);
      uint8_t* bs = sm + OFF_B + b * B_BYTES;
      for (int step = warp - 1; step < (BK / 8) * (BN / 64); step += 3) {
        const int r = 8 * (step % (BK / 8)) + lane % 8;          // K row of the slab
        const int ci = 4 * (step / (BK / 8)) + lane / 8;         // 16-column chunk, 0..7
        const uint4 in = *reinterpret_cast<const uint4*>(qs + r * 128 + ((ci ^ (r % 8)) * 16));
        uint4 lo8, hi8;
        widen16(in, lo8, hi8);
        *reinterpret_cast<uint4*>(bs + GB::offset(BK, r, 2 * ci)) = lo8;
        *reinterpret_cast<uint4*>(bs + GB::offset(BK, r, 2 * ci + 1)) = hi8;
      }
      fence_proxy_async();                     // the widened slab, for wgmma's reads
      __syncwarp();
      if (lane == 0) mbar_arrive(bfull(b));
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wc = wg - 1;                       // consumer 0 or 1: rows 64 wc .. 64 wc + 63
  // each slab's products sum in `part`, which is then added to `acc` in
  // f32: the tensor cores' own accumulation adds an error that grows with
  // the number of k16 steps it chains; one slab's 8 keep it at the split's
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const int s = j % STAGES, b = j % 2;
    mbar_wait(full(s), (j / STAGES) & 1);
    mbar_wait(bfull(b), (j / 2) & 1);
    const uint32_t bt = sm_s + OFF_B + b * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t bd = GB::mn_major(bt, BK, kk, 0);
      mma_ss_n128<1>(part, GA::k_major(a_tile(s, 0), BM, wc * 64, kk), bd, kk > 0);
      mma_ss_n128<1>(part, GA::k_major(a_tile(s, 1), BM, wc * 64, kk), bd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) {                           // this warp is done with stage s, buffer b
      mbar_arrive(empty(s));
      mbar_arrive(bempty(b));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // accumulator element 4 jn + e: row 16 warp + lane / 4 + 8 (e / 2),
  // column 8 jn + 2 (lane % 4) + e % 2
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = n0 + 8 * jn + 2 * (lane % 4);
    if (col >= n) continue;                    // n is even: col + 1 < n too
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wc * 64 + 16 * warp + lane / 4 + 8 * h;
      if (r < m)   // y is the wrapper's own allocation: 8-byte aligned pairs
        *reinterpret_cast<float2*>(y + (size_t)r * n + col) =
            make_float2(acc[4 * jn + 2 * h] * s0, acc[4 * jn + 2 * h + 1] * s1);
    }
  }
}

int launch_wgmma(const float* x, const int8_t* q, const float* scale, float* y, bf16* parts,
                 int m, int n, int k, cudaStream_t stream) {
  const int kp = (k + 7) / 8 * 8;
  const size_t groups = (size_t)m * (kp / 8);
  const size_t blocks = (groups + 255) / 256;
  split_x<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(x, parts, m, k,
                                                                                kp);
  cudaError_t err = cudaGetLastError();
  CUtensorMap mx, mq;
  if (err == cudaSuccess)
    err = make_map_3d(&mx, parts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kp, m, 2, BK, BM, 128);
  if (err == cudaSuccess)
    err = make_map_3d(&mq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, 1, BN, BK, 128);
  if (err == cudaSuccess)
    err = check_reg_budget(dequant_matmul_wgmma, THREADS,
                           PRODUCER_REGS * WGT + CONSUMER_REGS * 2 * WGT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dequant_matmul_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  dequant_matmul_wgmma<<<grid, THREADS, SMEM, stream>>>(mx, mq, scale, y, m, n, kp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// small M: f32 FMAs over the weight bytes, split over K
// ---------------------------------------------------------------------------

constexpr int RW_COLS = 16;                    // columns a lane carries: one 16-byte load a K row
constexpr int RW_STRIP = 32 * RW_COLS;         // columns a warp carries
constexpr int RW_WARPS = 4;
constexpr int RW_UNROLL = 8;                   // K rows whose loads are in flight together

// grid (strips / RW_WARPS, splits, row groups of ROWS); without a partial
// buffer (one split) the scaled sums go straight to y.  VEC: n % 16 == 0
// and q 16-byte aligned, so a lane's 16 columns are one aligned load.
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(RW_WARPS * 32)
dequant_matmul_rows(const float* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ y,
                    float* __restrict__ part, int m, int n, int k, int k_per_split) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = blockIdx.x * RW_WARPS + warp;
  if (strip * RW_STRIP >= n) return;
  const int c0 = strip * RW_STRIP + lane * RW_COLS;
  const int ks = blockIdx.y, m0 = blockIdx.z * ROWS;
  const int k_lo = ks * k_per_split, k_hi = min(k, k_lo + k_per_split);
  const float* xr[ROWS];                       // rows past m read row m - 1; never stored
#pragma unroll
  for (int r = 0; r < ROWS; ++r) xr[r] = x + (size_t)min(m0 + r, m - 1) * k;

  float acc[ROWS][RW_COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < RW_COLS; ++c) acc[r][c] = 0.f;

  // a group: RW_UNROLL K rows of q and of x; rows past the range load as 0
  // and add 0 * 0.  Two groups in registers: the next one's loads are in
  // flight while this one is summed.
  auto load = [&](int k0, uint32_t (&raw)[RW_UNROLL][4], float (&xv)[RW_UNROLL][ROWS]) {
#pragma unroll
    for (int u = 0; u < RW_UNROLL; ++u) {
      const int8_t* qr = q + (size_t)(k0 + u) * n + c0;
      if (k0 + u >= k_hi) {
        raw[u][0] = raw[u][1] = raw[u][2] = raw[u][3] = 0u;
      } else if (VEC && c0 + RW_COLS <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(qr));
        raw[u][0] = v.x; raw[u][1] = v.y; raw[u][2] = v.z; raw[u][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t w = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + 4 * i + b < n) w |= (uint32_t)(uint8_t)qr[4 * i + b] << (8 * b);
          raw[u][i] = w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RW_UNROLL; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xv[u][r] = k0 + u < k_hi ? __ldg(xr[r] + k0 + u) : 0.f;
  };
  auto sum = [&](const uint32_t (&raw)[RW_UNROLL][4], const float (&xv)[RW_UNROLL][ROWS]) {
#pragma unroll
    for (int u = 0; u < RW_UNROLL; ++u) {
      float w[RW_COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) widen4(raw[u][i], w + 4 * i);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < RW_COLS; ++c) acc[r][c] = fmaf(xv[u][r], w[c], acc[r][c]);
    }
  };
  uint32_t ra[RW_UNROLL][4], rb[RW_UNROLL][4];
  float xa[RW_UNROLL][ROWS], xb[RW_UNROLL][ROWS];
  load(k_lo, ra, xa);
  for (int k0 = k_lo; k0 < k_hi; k0 += 2 * RW_UNROLL) {
    load(k0 + RW_UNROLL, rb, xb);
    sum(ra, xa);
    load(k0 + 2 * RW_UNROLL, ra, xa);
    sum(rb, xb);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (m0 + r >= m) break;
#pragma unroll
    for (int c = 0; c < RW_COLS; ++c) {
      if (c0 + c >= n) break;
      const size_t o = (size_t)(m0 + r) * n + c0 + c;
      if (part == nullptr)
        y[o] = acc[r][c] * scale[c0 + c];
      else
        part[(size_t)ks * m * n + o] = acc[r][c];
    }
  }
}

// y = (sum over splits, in order) * scale; eight splits' loads in flight
// before they are added, in order
__global__ void dequant_matmul_reduce(const float* __restrict__ part,
                                      const float* __restrict__ scale, float* __restrict__ y,
                                      int m, int n, int splits) {
  const size_t total = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    int ks = 0;
    for (; ks + 8 <= splits; ks += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(size_t)(ks + u) * total + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; ks < splits; ++ks) s += part[(size_t)ks * total + i];
    y[i] = s * scale[i % n];
  }
}

template <int ROWS>
cudaError_t launch_rows_of(const float* x, const int8_t* q, const float* scale, float* y,
                           float* part, int m, int n, int k, int k_per_split, int splits,
                           cudaStream_t stream) {
  const int strips = (n + RW_STRIP - 1) / RW_STRIP;
  const dim3 grid((strips + RW_WARPS - 1) / RW_WARPS, splits, (m + ROWS - 1) / ROWS);
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0)
    dequant_matmul_rows<ROWS, true><<<grid, RW_WARPS * 32, 0, stream>>>(
        x, q, scale, y, part, m, n, k, k_per_split);
  else
    dequant_matmul_rows<ROWS, false><<<grid, RW_WARPS * 32, 0, stream>>>(
        x, q, scale, y, part, m, n, k, k_per_split);
  return cudaGetLastError();
}

// a warp carries 1, 2 or 4 rows of x: the fewest that cover m, 4 past 4
int launch_rows(const float* x, const int8_t* q, const float* scale, float* y, float* part,
                int m, int n, int k, int splits, cudaStream_t stream) {
  const int k_per_split = (k + splits - 1) / splits;
  float* p = splits > 1 ? part : nullptr;
  cudaError_t err;
  if (m == 1)
    err = launch_rows_of<1>(x, q, scale, y, p, m, n, k, k_per_split, splits, stream);
  else if (m == 2)
    err = launch_rows_of<2>(x, q, scale, y, p, m, n, k, k_per_split, splits, stream);
  else
    err = launch_rows_of<4>(x, q, scale, y, p, m, n, k, k_per_split, splits, stream);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t blocks = ((size_t)m * n + 255) / 256;
  dequant_matmul_reduce<<<(unsigned)(blocks < 132 * 8 ? blocks : 132 * 8), 256, 0, stream>>>(
      part, scale, y, m, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// route 1: the wgmma route, with x_parts (2, m, k rounded up to 8) bf16
// scratch from a 16-byte aligned start; n % 16 == 0 and q 16-byte aligned.
// route 0: the rows route, with partial (splits, m, n) f32 scratch when
// splits > 1 (k_per_split = ceil(k / splits) rows each).
extern "C" int dl4j_dequant_matmul(const void* x, const void* q, const void* scale, void* y,
                                   void* x_parts, void* partial, int m, int n, int k, int route,
                                   int splits, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // start from a clean error state
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  if (route == 1) {
    if (k <= 0 || n % 16 != 0 || (m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    return launch_wgmma(xf, qi, sc, yf, static_cast<bf16*>(x_parts), m, n, k, s);
  }
  if (splits < 1 || splits > 65535 || (m + 3) / 4 > 65535 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_rows(xf, qi, sc, yf, static_cast<float*>(partial), m, n, k, splits, s);
}
