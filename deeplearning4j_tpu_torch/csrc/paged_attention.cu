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
// What bounds it on the H100: bytes, and at decode sizes latency.  Each live
// K/V element is read once and used for one multiply-add (~0.5 FLOP a byte
// in f32), and no two heads share an operand, so there is nothing for the
// tensor cores: 3.35 TB/s sets the floor (6.5 us for the serve mix's 22 MB
// of f32 pages), and a decode step's few megabytes leave a chain of
// dependent memory round trips (lengths, table, pages, partials) as long as
// the transfer itself.  The design keeps every page of the step in flight at
// once and keeps the chain short.
//
// Design (flash-decoding):
// - Split.  The work is cut into items (slot, chunk, head group), a chunk
//   being `pages_per_chunk` pages of the slot's table.  The wrapper picks
//   both (`split_plan`): the largest of 4, 2, 1 heads that divides H with
//   group x Dh <= 256 elements, and the most of 4, 2, 1 pages whose group
//   slices fit in 64 KB of shared memory, so three blocks share an SM.  At
//   the flagship widths (H 8, Dh 128, ps 16) that is 2 heads and 2 pages
//   for f32 (the serve mix's 2017-position slot alone is 64 chunks x 4
//   groups = 256 items on 132 SMs, where the one-block-per-(slot, head)
//   design gave it 8 blocks) and 2 heads and 4 pages for int8 (128 items:
//   half the partials to merge; measured faster than 2 pages at the serve
//   mix and the full pool).
// - Grid.  Fixed by the shapes and the card, never by seq_lens: twice as
//   many blocks as the card holds at once (the occupancy API), at most
//   S x chunks x groups.  The host never reads seq_lens and never syncs,
//   so a decode step can be captured in a CUDA graph.  Each block reads
//   every slot's seq_len into shared memory once, counts the slots' live items with
//   a block-wide prefix sum, and walks the live items b, b + grid, ...: no
//   block is spent on a chunk at or past seq_len, and no page there is
//   read.  (One block an item, most of them leaving at once, cost ~2-4 us
//   more at the serve mix's 160-wide tables: a 2,560-block grid with every
//   slot idle read 0.0091 ms, a 160-block one 0.0058.)  The second resident
//   set of blocks starts as the first finishes, so a block with two items
//   does not leave its SM waiting on one item's round trips.
// - Copy.  A pool page is one contiguous (ps, H, Dh) block; the group's
//   share of a position is group x Dh contiguous elements (1 KB f32, 256 B
//   int8 at the flagship).  One warp issues every copy of the chunk at once
//   into shared memory, one mbarrier a page: a whole page as one TMA box of
//   the group's slice (a tensor map a pool: group x Dh elements by ps
//   rows); a slot's last, partial page with `cp.async.bulk` (1-D TMA), a
//   row at a time, or its live rows in one copy where the group is all
//   heads; with int8 pages, the page's scale rows too (one copy each for K
//   and V, rounded up to 16 bytes inside the page).  Rows at or past
//   seq_len are never copied, and nothing is gathered into a dense copy.
// - Compute in f32 from shared memory.  The 4 warps split into one team a
//   head of the group; a team's warps take a page's rows in turn, 8 rows
//   scored before one online-softmax update (running max, normaliser and a
//   Dh-wide accumulator per warp), and the team is merged in warp order.
//   Lanes: where 32 divides Dh a lane holds Dh/32 contiguous elements
//   (one 16-byte read at Dh 128); otherwise element lane, lane + 32, ...
//   with the lanes past the row's end idle.  int8: values widened by a byte
//   permute into 2^23 + (b ^ 0x80) less 2^23 + 128 (exact; I2F runs at an
//   eighth of the FMA rate and made int8 pages compute 2.5x slower than
//   f32); q . k on them times the row's K scale once per score, and p times
//   the row's V scale once per row.
// - Merge in a fixed order, one writer an element.  A slot with one live
//   chunk writes its output directly.  Otherwise each chunk writes its
//   partial (m, l, acc) to an f32 workspace the wrapper allocates, chunk-
//   major for each (slot, group), and the last block of a (slot, group) to
//   arrive, told by a ticket counter it resets to 0 for the next launch (no
//   memset a call), merges them: a tile of chunks' accumulators in one bulk
//   copy into its page buffers while their (m, l) load beside, each head's
//   max over the tile, every chunk's weight against it at once, then thread
//   subsets summing chunks j, j + J, ... in order and the subsets summed in
//   order.  (A running rescale chained two exps a chunk and five L2 round
//   trips; it took ~6 us of the serve mix, the tiles ~2.5.)  Which block
//   merges varies from run to run; what it computes does not, so a second
//   launch gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"   // mbarriers, shared-memory addresses

namespace {

constexpr int NW = 4;                 // warps a block
constexpr int THREADS = NW * 32;
constexpr int U = 8;                  // rows a warp scores before one update
constexpr int MAX_PPC = 4;            // pages a chunk
constexpr int MAX_ROW = 256;          // group x Dh elements
constexpr int OVERSUB = 2;            // grid: resident blocks x OVERSUB
constexpr int MERGE_ML = 128;         // (chunk, head) partials a merge tile holds
constexpr int SMEM_PAGES = 200 * 1024;
constexpr int MAX_SLOTS = 2048;       // slots' lengths kept in shared memory
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
__device__ __forceinline__ void load_row(const float* p, int lane, float* dst) {
  using L = Lanes<DH>;
  if constexpr (L::CONTIG && L::NE % 4 == 0) {
#pragma unroll
    for (int e = 0; e < L::NE; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + L::idx(lane, e));
      dst[e] = x.x; dst[e + 1] = x.y; dst[e + 2] = x.z; dst[e + 3] = x.w;
    }
  } else if constexpr (L::CONTIG && L::NE % 2 == 0) {
#pragma unroll
    for (int e = 0; e < L::NE; e += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + L::idx(lane, e));
      dst[e] = x.x; dst[e + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < L::NE; ++e) dst[e] = L::ok(lane, e) ? p[L::idx(lane, e)] : 0.f;
  }
}

template <int DH>
__device__ __forceinline__ void load_row(const int8_t* p, int lane, float* dst) {
  using L = Lanes<DH>;
  if constexpr (L::CONTIG && L::NE % 4 == 0) {
    // 2^23 + (b ^ 0x80) built by a byte permute, less 2^23 + 128: exact, and
    // cheaper than I2F, which runs at an eighth of the FMA rate
#pragma unroll
    for (int e = 0; e < L::NE; e += 4) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p + L::idx(lane, e)) ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[e + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < L::NE; ++e) dst[e] = L::ok(lane, e) ? (float)p[L::idx(lane, e)] : 0.f;
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned); completes the bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  CUtensorMap kmap, vmap;   // pools as (P, ps, H x Dh), read in (group x Dh, ps) boxes
  const float* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* tbl;
  const int* lens;
  float* out;
  float* ws_acc;      // (S, groups, chunks, group x Dh) partial accumulators
  float* ws_ml;       // (S, groups, chunks, group, 2) partial running max, normaliser
  int* tickets;       // (S, groups), 0 between launches
  int slots, heads, ps, max_pages, hg, ppc, chunks, groups;
  int page_stride;    // shared-memory bytes of one page's slice
  int region;         // shared-memory bytes of the pages, reused by the merge
  float sm_scale;
};

// inclusive prefix sum of v over the block's threads; *total gets the sum
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return v + before;
}

template <typename KT, int DH, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const __grid_constant__ Args a) {
  using L = Lanes<DH>;
  constexpr int NE = L::NE;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[MAX_PPC];
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ __align__(16) float sm_acc[NW][DH];
  __shared__ __align__(16) float4 sub_acc[THREADS];
  __shared__ float sub_l[THREADS];
  __shared__ float head_max[NW][4];
  __shared__ float run_max[4], new_max[4];
  __shared__ float2 tile_ml[MERGE_ML];
  __shared__ float tile_w[MERGE_ML];
  __shared__ int warp_sums[NW];
  __shared__ int sm_last;

  const int hg = a.hg, heads = a.heads, ps = a.ps, slots = a.slots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = a.ppc * ps;                       // positions a chunk
  const int row = hg * DH;                           // elements of a position
  const int kv_bytes = ps * row * (int)sizeof(KT);   // K (or V) rows of a page
  const int kv_stride = round_up(kv_bytes, 128);      // TMA writes 128-byte aligned
  const int sc_bytes = QUANT ? ps * heads * 4 : 0;   // K (or V) scales of a page
  // after the pages: each slot's length, and the live items before each slot
  int* s_len = reinterpret_cast<int*>(smem + a.region);
  int* s_pre = s_len + slots;

  if (threadIdx.x == 0) {
    for (int j = 0; j < MAX_PPC; ++j) mbar_init(smem_addr(&bars[j]), 1);
    mbar_init_fence();
    s_pre[0] = 0;
  }
  int carry = 0;
  for (int s0 = 0; s0 < slots; s0 += THREADS) {
    const int s = s0 + threadIdx.x;
    int items = 0;
    if (s < slots) {
      const int len = min(a.lens[s], a.max_pages * ps);
      s_len[s] = len;
      items = len > 0 ? (len + span - 1) / span * a.groups : 0;
    }
    int total;
    const int incl = block_scan(items, warp_sums, &total);
    if (s < slots) s_pre[s + 1] = carry + incl;
    carry += total;
  }
  __syncthreads();
  const int n_items = carry;

  // idle slots: exact zeros, one block a slot
  for (int s = blockIdx.x; s < slots; s += gridDim.x) {
    if (s_len[s] > 0) continue;
    float* o = a.out + (size_t)s * heads * DH;
    for (int i = threadIdx.x; i < heads * DH; i += THREADS) o[i] = 0.f;
  }

  uint32_t phase = 0;   // bit j: parity of bars[j]'s next phase
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // the item's slot: the last s with s_pre[s] <= item
    int lo = 0, hi = slots - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_pre[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int s = lo, r = item - s_pre[s];
    const int c = r / a.groups, g = r % a.groups, h0 = g * hg;
    const int len = s_len[s];
    const int start = c * span;
    const int n_chunks = (len + span - 1) / span;
    const int np = min(a.ppc, (len - start + ps - 1) / ps);   // live pages

    if (warp == 0) {   // every copy of the chunk, all in flight together
      const int* trow = a.tbl + (size_t)s * a.max_pages + c * a.ppc;
      const int my_page = lane < np ? trow[lane] : 0;
      fence_proxy_async();   // the last item's reads of these buffers come first
      for (int j = 0; j < np; ++j) {
        const int page = __shfl_sync(0xffffffffu, my_page, j);
        const int n = min(ps, len - (c * a.ppc + j) * ps);   // live rows
        const uint32_t base = smem_addr(smem + j * a.page_stride);
        const uint32_t bar = smem_addr(&bars[j]);
        const uint32_t row_bytes = row * sizeof(KT);
        const uint32_t sc_copy = QUANT ? min(round_up(n * heads * 4, 16), sc_bytes) : 0;
        if (lane == 0) mbar_expect_tx(bar, 2 * n * row_bytes + 2 * sc_copy);
        __syncwarp();
        const size_t first = ((size_t)page * ps * heads + h0) * DH;   // element of row 0
        const KT* kp = static_cast<const KT*>(a.kp) + first;
        const KT* vp = static_cast<const KT*>(a.vp) + first;
        if (n == ps) {   // a whole page: one box of the group's slice from each pool
          if (lane == 0) {
            tma_load(base, &a.kmap, bar, h0 * DH, 0, page);
            tma_load(base + kv_stride, &a.vmap, bar, h0 * DH, 0, page);
          }
        } else if (hg == heads) {   // the live rows of the whole row are contiguous
          if (lane == 0) {
            bulk_load(base, kp, n * row_bytes, bar);
            bulk_load(base + kv_stride, vp, n * row_bytes, bar);
          }
        } else {
          for (int rr = lane; rr < n; rr += 32) {
            const size_t off = (size_t)rr * heads * DH;
            bulk_load(base + rr * row_bytes, kp + off, row_bytes, bar);
            bulk_load(base + kv_stride + rr * row_bytes, vp + off, row_bytes, bar);
          }
        }
        if (QUANT && lane == 0) {
          const size_t sc0 = (size_t)page * ps * heads;
          bulk_load(base + 2 * kv_stride, a.ks + sc0, sc_copy, bar);
          bulk_load(base + 2 * kv_stride + sc_bytes, a.vs + sc0, sc_copy, bar);
        }
      }
    }

    // this warp's head, and its turn among the head's team
    const int hh = warp % hg, team = NW / hg, ti = warp / hg;
    const int h = h0 + hh;
    float qv[NE];
    load_row<DH>(a.q + ((size_t)s * heads + h) * DH, lane, qv);
    float m = NEG, l = 0.f, acc[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[e] = 0.f;

    for (int j = 0; j < np; ++j) {
      const int n = min(ps, len - (c * a.ppc + j) * ps);
      const unsigned char* base = smem + j * a.page_stride;
      const KT* kr = reinterpret_cast<const KT*>(base) + hh * DH;
      const KT* vr = reinterpret_cast<const KT*>(base + kv_stride) + hh * DH;
      const float* ksr = reinterpret_cast<const float*>(base + 2 * kv_stride) + h;
      const float* vsr = reinterpret_cast<const float*>(base + 2 * kv_stride + sc_bytes) + h;
      mbar_wait(smem_addr(&bars[j]), (phase >> j) & 1);
      for (int r0 = ti; r0 < n; r0 += team * U) {
        float sc[U];
        float mx = NEG;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rr = r0 + u * team;
          float d = 0.f;
          if (rr < n) {
            float kv[NE];
            load_row<DH>(kr + (size_t)rr * row, lane, kv);
#pragma unroll
            for (int e = 0; e < NE; ++e) d = fmaf(qv[e], kv[e], d);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
          if constexpr (QUANT) {
            if (rr < n) d *= ksr[rr * heads];
          }
          sc[u] = rr < n ? d * a.sm_scale : NEG;
          mx = fmaxf(mx, sc[u]);
        }
        const float m_new = fmaxf(m, mx);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rr = r0 + u * team;
          if (rr < n) {
            const float p = expf(sc[u] - m_new);
            l += p;
            float pv = p;
            if constexpr (QUANT) pv *= vsr[rr * heads];
            float vv[NE];
            load_row<DH>(vr + (size_t)rr * row, lane, vv);
#pragma unroll
            for (int e = 0; e < NE; ++e) acc[e] = fmaf(pv, vv[e], acc[e]);
          }
        }
        m = m_new;
      }
    }
    phase ^= (1u << np) - 1;

    // merge each head's team in warp order
    if (lane == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (L::ok(lane, e)) sm_acc[warp][L::idx(lane, e)] = acc[e];
    __syncthreads();
    const size_t sg = (size_t)s * a.groups + g;   // partials of (s, g): chunk-major
    for (int i = threadIdx.x; i < row; i += THREADS) {
      const int ih = i / DH, d = i % DH;
      float big = NEG;
      for (int t = 0; t < team; ++t) big = fmaxf(big, sm_m[t * hg + ih]);
      float ll = 0.f, aa = 0.f;
      for (int t = 0; t < team; ++t) {
        const int w = t * hg + ih;
        const float f = expf(sm_m[w] - big);   // a warp with no rows: f = 0
        ll += sm_l[w] * f;
        aa += sm_acc[w][d] * f;
      }
      if (n_chunks == 1) {
        a.out[((size_t)s * heads + h0) * DH + i] = aa / ll;
      } else {
        a.ws_acc[(sg * a.chunks + c) * row + i] = aa;
        if (d == 0) {
          a.ws_ml[((sg * a.chunks + c) * hg + ih) * 2] = big;
          a.ws_ml[((sg * a.chunks + c) * hg + ih) * 2 + 1] = ll;
        }
      }
    }
    if (n_chunks > 1) {
      // the last block of (s, g) to arrive merges every chunk's partial
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        int* ticket = a.tickets + (size_t)s * a.groups + g;
        const int t = atomicAdd(ticket, 1);
        sm_last = t == n_chunks - 1;
        if (sm_last) *ticket = 0;   // ready for the next launch
      }
      __syncthreads();
      if (sm_last) {
        __threadfence();
        // the partials, written by other blocks, are read by the bulk copy
        if (threadIdx.x == 0) asm volatile("fence.proxy.async;\n" ::: "memory");
        const int t = threadIdx.x;
        const float* acc0 = a.ws_acc + sg * a.chunks * row;
        const float2* ml0 = reinterpret_cast<const float2*>(a.ws_ml) + sg * a.chunks * hg;
        // tiles of chunks: their accumulators in one bulk copy into the page
        // buffers, their (m, l) beside them in tile_ml
        const int cap = min(a.region / (row * 4), MERGE_ML / hg);
        const int cols = row / 4;             // float4 columns of the group's row
        const int subsets = THREADS / cols;   // >= 2: row <= 256
        const bool summer = t < cols * subsets;
        const int col = t % cols, sub = t / cols, ih = col * 4 / DH;
        const float* tile = reinterpret_cast<const float*>(smem);
        const uint32_t bar = smem_addr(&bars[0]);
        if (t < hg) run_max[t] = NEG;
        float ll = 0.f;
        float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c0 = 0; c0 < n_chunks; c0 += cap) {
          const int nt = min(cap, n_chunks - c0);
          if (t == 0) {
            mbar_expect_tx(bar, nt * row * 4);
            bulk_load(smem_addr(smem), acc0 + (size_t)c0 * row, nt * row * 4, bar);
          }
          for (int e = t; e < nt * hg; e += THREADS) tile_ml[e] = __ldcg(ml0 + (size_t)c0 * hg + e);
          __syncthreads();
          // each head's max, over the tile and the tiles before (entry e is
          // head e % hg, and so is every entry thread t reads)
          float big = NEG;
          for (int e = t; e < nt * hg; e += THREADS) big = fmaxf(big, tile_ml[e].x);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            if (off >= hg) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
          if (lane < hg) head_max[warp][lane] = big;
          __syncthreads();
          if (t < hg) {
            float mh = run_max[t];
            for (int w = 0; w < NW; ++w) mh = fmaxf(mh, head_max[w][t]);
            new_max[t] = mh;
          }
          __syncthreads();
          // every chunk's weight against that max: no weight waits for another
          for (int e = t; e < nt * hg; e += THREADS)
            tile_w[e] = expf(tile_ml[e].x - new_max[e % hg]);
          __syncthreads();
          mbar_wait(bar, phase & 1);
          if (summer) {   // sums in chunk order
            const float f = expf(run_max[ih] - new_max[ih]);   // first tile: 0
            ll *= f;
            aa.x *= f; aa.y *= f; aa.z *= f; aa.w *= f;
            for (int cc = sub; cc < nt; cc += subsets) {
              const float w = tile_w[cc * hg + ih];
              const float4 x = reinterpret_cast<const float4*>(tile + (size_t)cc * row)[col];
              ll = fmaf(tile_ml[cc * hg + ih].y, w, ll);
              aa.x = fmaf(x.x, w, aa.x); aa.y = fmaf(x.y, w, aa.y);
              aa.z = fmaf(x.z, w, aa.z); aa.w = fmaf(x.w, w, aa.w);
            }
          }
          phase ^= 1u;
          __syncthreads();
          if (t < hg) run_max[t] = new_max[t];
        }
        if (summer) {
          sub_acc[t] = aa;
          sub_l[t] = ll;
        }
        __syncthreads();
        if (t < cols) {
          float lsum = 0.f;
          float4 asum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int k = 0; k < subsets; ++k) {
            const float4 x = sub_acc[k * cols + t];
            lsum += sub_l[k * cols + t];
            asum.x += x.x; asum.y += x.y; asum.z += x.z; asum.w += x.w;
          }
          const float inv = 1.f / lsum;
          reinterpret_cast<float4*>(a.out + ((size_t)s * heads + h0) * DH)[t] =
              make_float4(asum.x * inv, asum.y * inv, asum.z * inv, asum.w * inv);
        }
      }
    }
    __syncthreads();   // the next item's copies reuse the page buffers
  }
}

constexpr int MAX_DEVICES = 64;

template <typename KT, int DH, bool QUANT>
int launch_dh(const Args& a, int smem, cudaStream_t stream) {
  auto kernel = paged_split_kernel<KT, DH, QUANT>;
  // Per device, the shared memory this kernel was allowed and the blocks an
  // SM then holds, asked once per size: a decode step launches this kernel
  // once a layer and is bound by the host.  (A race between two host threads
  // repeats a query; any grid is correct.)
  static int allowed[MAX_DEVICES], resident_for[MAX_DEVICES], resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] < smem) {
    // dynamic and static shared memory together may pass the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  if (resident_for[dev] != smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
        cudaSuccess)
      return (int)err;
    resident[dev] = sms * std::max(per_sm, 1);
    resident_for[dev] = smem;
  }
  // twice what the card holds at once, never more than there could be items;
  // each block walks the live items b, b + grid, ...
  const long long most = (long long)a.slots * a.chunks * a.groups;
  const int grid = (int)std::max(1LL, std::min((long long)resident[dev] * OVERSUB, most));
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename KT, bool QUANT>
int launch(const Args& a, int dh, int smem, cudaStream_t stream) {
  switch (dh) {
#define DL4J_PA_CASE(D) \
  case D: return launch_dh<KT, D, QUANT>(a, smem, stream);
    DL4J_PA_CASE(16) DL4J_PA_CASE(32) DL4J_PA_CASE(48) DL4J_PA_CASE(64)
    DL4J_PA_CASE(80) DL4J_PA_CASE(96) DL4J_PA_CASE(112) DL4J_PA_CASE(128)
    DL4J_PA_CASE(144) DL4J_PA_CASE(160) DL4J_PA_CASE(176) DL4J_PA_CASE(192)
    DL4J_PA_CASE(208) DL4J_PA_CASE(224) DL4J_PA_CASE(240) DL4J_PA_CASE(256)
#undef DL4J_PA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ws: S * chunks * H * (Dh + 2) f32 (accumulators, then (m, l) pairs);
// tickets: S * (H / head_group) int32, all 0 (and left 0); chunks =
// ceil(max_pages / pages_per_chunk).  Pools, scales and q 16-byte aligned.
extern "C" int dl4j_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const void* page_tbl, const void* seq_lens, void* out,
                                    void* ws, void* tickets, int slots, int heads,
                                    int head_dim, int num_pages, int page_size,
                                    int max_pages, int head_group, int pages_per_chunk,
                                    int int8, float sm_scale, void* stream) {
  if (slots <= 0 || slots > MAX_SLOTS || heads <= 0 || num_pages <= 0 || page_size <= 0 ||
      page_size > 256 ||
      max_pages <= 0 || head_dim <= 0 || head_dim % 16 != 0 ||
      !(head_group == 1 || head_group == 2 || head_group == 4) ||
      heads % head_group != 0 ||
      head_group * head_dim > MAX_ROW || pages_per_chunk < 1 ||
      pages_per_chunk > MAX_PPC || (int8 && (page_size * heads) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int elem = int8 ? 1 : 4;
  const int page_stride =
      round_up(2 * round_up(page_size * head_group * head_dim * elem, 128) +
                   (int8 ? 2 * page_size * heads * 4 : 0),
               128);
  if (pages_per_chunk * page_stride > SMEM_PAGES) return (int)cudaErrorInvalidValue;
  // the pages (at least one chunk's partial for the merge), then each slot's
  // length and the live items before each slot
  const int region = std::max(pages_per_chunk * page_stride, head_group * head_dim * 4);
  const int smem = region + round_up((2 * slots + 1) * 4, 16);
  (void)cudaGetLastError();  // start from a clean error state
  const int chunks = (max_pages + pages_per_chunk - 1) / pages_per_chunk;
  if ((long long)slots * chunks * (heads / head_group) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t n_acc = (size_t)slots * chunks * heads * head_dim;
  Args a;
  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  for (int i = 0; i < 2; ++i) {
    const cudaError_t err = make_map_3d(i ? &a.vmap : &a.kmap, i ? v_pages : k_pages, type,
                                        elem, (uint64_t)heads * head_dim, page_size,
                                        num_pages, head_group * head_dim, page_size, 0);
    if (err != cudaSuccess) return (int)err;
  }
  a.q = static_cast<const float*>(q);
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.tbl = static_cast<const int*>(page_tbl);
  a.lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<float*>(out);
  a.ws_acc = static_cast<float*>(ws);
  a.ws_ml = static_cast<float*>(ws) + n_acc;
  a.tickets = static_cast<int*>(tickets);
  a.slots = slots;
  a.heads = heads;
  a.ps = page_size;
  a.max_pages = max_pages;
  a.hg = head_group;
  a.ppc = pages_per_chunk;
  a.chunks = chunks;
  a.page_stride = page_stride;
  a.region = region;
  a.sm_scale = sm_scale;
  a.groups = heads / head_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8) return launch<int8_t, true>(a, head_dim, smem, st);
  return launch<float, false>(a, head_dim, smem, st);
}
