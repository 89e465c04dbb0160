// wgmma.cuh — shared pieces of the Hopper (sm_90a) tensor-core kernels:
// the swizzled bf16 tile geometry and its wgmma descriptors, the wgmma
// instructions (shared-memory and register A operands), their fences, bf16
// packing, the split of an f32 value into two bf16 parts and the pre-pass
// kernel that splits whole f32 tensors, mbarriers, named barriers and TMA
// loads with the host-side tensor-map encoder.
// Included by flash_fwd.cu, flash_bwd.cu and dequant_matmul.cu;
// runtime/kernels.py hashes it into the name of every library whose source
// includes it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of a bf16 tile of R rows and D columns.  Each row is
// cut into column blocks of RB bytes (64 columns at D >= 64); column block c
// of the tile is R rows of RB bytes at offset c * R * RB, and the 16-byte
// chunks of row r are permuted by the swizzle wgmma's descriptor names
// (128B: chunk ^= r % 8; 64B and 32B: the same on the address bits 7+).  Read
// with rows as M or N and columns as K, the tile is wgmma's K-major layout;
// read with rows as K and columns as N, its MN-major (transposed) layout.
template <int D>
struct Geo {
  static constexpr int RB = D >= 64 ? 128 : 2 * D;         // bytes of a swizzled row
  static constexpr int CB = 2 * D / RB;                    // column blocks
  static constexpr int NB = RB / 2;                        // columns of a column block
  static constexpr int KPB = RB / 32;                      // k16 steps in a column block
  static constexpr uint32_t SW_MASK = RB / 16 - 1;         // swizzle bits
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int CHUNKS = 2 * D / 16;                // 16-byte chunks a row

  // byte offset of chunk cc (of the whole row) of row r, in an R-row tile
  static __device__ __forceinline__ uint32_t offset(int rows, int r, int cc) {
    const int c = cc / (RB / 16), j = cc % (RB / 16);
    uint32_t o = r * RB + j * 16;
    o ^= ((o >> 7) & SW_MASK) << 4;
    return c * rows * RB + o;
  }
  // wgmma shared-memory descriptor: start address, leading and stride byte
  // offsets (16-byte units), swizzle mode
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (LAYOUT << 62);
  }
  // K-major operand: rows [r0, r0 + 64) (A) or the tile's first N rows (B)
  // of an R-row tile, columns [16 kk, 16 kk + 16)
  static __device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows, int r0, int kk) {
    return desc(tile + (kk / KPB) * rows * RB + r0 * RB + (kk % KPB) * 32, 16, 8 * RB);
  }
  // MN-major B operand: rows [16 kk, 16 kk + 16) as K, column block c as N
  static __device__ __forceinline__ uint64_t mn_major(uint32_t tile, int rows, int kk, int c) {
    return desc(tile + c * rows * RB + kk * 16 * RB, rows * RB, 8 * RB);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this thread's generic-proxy writes to shared memory (cp.async, st.shared)
// become visible to wgmma's async-proxy reads (after the block's barrier)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A B: A 64 x 16 and B 16 x 32 from shared memory, both K-major
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B: A 64 x 16 and B 16 x 64 from shared memory, both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B: A 64 x 16 (K-major) and B 16 x 128 from shared memory; B is
// K-major when TB is 0, MN-major (rows of N contiguous) when 1
template <int TB = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TB));
}

// d (+)= A B: A 64 x 16 from registers, B 16 x N from shared memory, MN-major;
// d is overwritten, not added to, when acc is 0
template <int N> struct MmaRs;
template <> struct MmaRs<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int acc = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct MmaRs<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int acc = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct MmaRs<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int acc = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) = hi + lo in two bf16 parts: hi = bf16(x), lo = bf16(x - hi); the
// pair carries ~16 significant bits, and hi * y + lo * y is x * y to ~2^-16
// (every bf16 x bf16 product is exact in f32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// The f32 kernels' pre-pass: W contiguous f32 tensors of n elements each
// (n even), the first times scale0, into parts (W, 2, n) bf16: tensor w's hi
// part at (2 w) n, its lo part at (2 w + 1) n.  One thread a pair, plain
// loads, so the f32 tensors need only be 4-byte aligned.
template <int W>
struct SplitSrcs {
  const float* a[W];
};

template <int W>
__global__ void split_parts(const SplitSrcs<W> src, bf16* __restrict__ parts, size_t n,
                            float scale0) {
  const size_t pairs = n / 2;
  uint32_t* out = reinterpret_cast<uint32_t*>(parts);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < W * pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const int w = (int)(i / pairs);
    const size_t p = i - w * pairs;
    const float* a = src.a[0];
#pragma unroll
    for (int x = 1; x < W; ++x)
      if (w == x) a = src.a[x];
    const float f = w == 0 ? scale0 : 1.f;
    uint32_t hi, lo;
    split_bf16(a[2 * p] * f, a[2 * p + 1] * f, hi, lo);
    out[2 * w * pairs + p] = hi;
    out[(2 * w + 1) * pairs + p] = lo;
  }
}

template <int W>
inline cudaError_t launch_split_parts(const SplitSrcs<W>& src, bf16* parts, size_t n,
                                      float scale0, cudaStream_t stream) {
  const size_t blocks = (W * n / 2 + 255) / 256;
  split_parts<W><<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      src, parts, n, scale0);
  return cudaGetLastError();
}

// -- mbarriers, named barriers, TMA ------------------------------------------

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
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda link)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
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

// 3-D tensor map over a dense (d2, d1, d0) array (d0 fastest) of `elem`-byte
// elements at `base`, read in (b0, b1, 1) boxes with the given swizzle
// (0: none; else the swizzle span in bytes: 32, 64 or 128); out-of-bounds
// elements read as zeros
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                               int elem, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b0,
                               uint32_t b1, int swizzle_bytes) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};   // bytes
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 3-D map (D, T, heads) of contiguous bf16 (heads, T, D) at base; a box is
// one column block of `rows` rows of one head, swizzled as `Geo<D>`
template <int D>
cudaError_t make_tile_map(CUtensorMap* map, const void* base, int heads, int t, int rows) {
  using G = Geo<D>;
  return make_map_3d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, t, heads, G::NB, rows,
                     G::RB);
}

// setmaxnreg only moves registers within the block's allocation: a block
// launched with fewer than its roles' total would wait forever
template <typename K>
inline cudaError_t check_reg_budget(K kernel, int threads, int budget) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs * threads < budget ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Accumulator layout of a wgmma m64nN f32 tile, thread `lane` of warp `w` of
// the warpgroup: element 4 j + e is row 16 w + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.  Elements 8 kk .. 8 kk + 7, rounded to bf16 in
// pairs, are the register A fragment of k16 step kk of the next product.

}  // namespace
