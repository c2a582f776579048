// Paged decode attention over a bit-plane KV cache, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/paged_attention/kernel.py:
//   * paged_attention_fused (_fused_kernel): one launch over the
//     mixed-precision cache, each page read at its own plane count, output
//     normalised, rows with nothing valid written as 0;
//   * paged_attention_rung (_kernel): the same attention at one plane count
//     for every masked-in token, output as unnormalised partials
//     (acc, m, l) that the caller merges across rungs.
//
// Layouts (the reference's, unchanged):
//   q        (B, Hkv, rep, hd)          bf16
//   k/v      (16, B, S, Hkv, hd/8)      uint8; bit i (0 = MSB) of value d of
//                                       token s sits in planes[i][b][s][h]
//                                       [d/8] at bit 7 - d%8
//   keeps    (B, S/16)                  int32 (fused only)
//   mask     (B, S)                     int8, > 0 = valid
//   out      (B, Hkv, rep, hd)          float32
//   m, l     (B, Hkv, rep)              float32 (rung only)
// hd % 8 == 0 and hd <= 256; S % 16 == 0; any rep.
//
// What bounds it on this card: bytes.  Per layer the kernel must move
// sum over read pages of keep * 16 * Hkv * (hd/8) bytes for each of K and V,
// plus q, the mask and the output; it does about 4 flops per value it
// rebuilds, far below the H100's ~300 operations per byte.  A page whose 16
// mask bytes are all zero, or whose keep is 0, is never read, and no plane
// at or past a page's keep is read.
//
// The design (the launch plan is kernel.py: plan(b, s, hkv, rep, hd), from
// the shapes alone; the valid lengths stay on the device):
// - Grid (splits, B, head groups x query groups).  A block takes one batch
//   row, a fixed range of pages (a split of S, as in flash-decoding) and
//   `heads` kv heads: all of them unless 4 compute warps or shared memory
//   force groups.  Splits are as few as give every SM a block (two up to 64
//   dims): 32 of 2 pages at the serving shape (B 8, S 1024), 16 of 16
//   pages at B 8, S 4096.
// - Warp roles: rebuild warps (7, or 11 above 64 dims), one producer warp
//   and one compute warp per (kv head, 16 query rows).  Warp 0 lists the
//   range's live pages (keep > 0 and a valid token) and issues the first
//   loads; the producer issues the rest as stages free up.
// - Loads: with every head in the block, one plane of one page is one
//   contiguous run of 16 * Hkv * hd/8 bytes.  The producer's lane 0 copies
//   a page's kept planes by TMA (3-D tensor maps over (run bytes, runs,
//   planes), one copy per power of two in keep, for K and for V) into a
//   ring of stages (as many as fit, up to 8), completing on the stage's
//   mbarrier; stage k is refilled as soon as its page is rebuilt.  A head
//   group, or a run that is no multiple of 128 bytes, is copied by
//   cp.async from the rebuild threads instead.
// - Rebuild: each rebuild thread keeps the same 4-byte words of the page's
//   plane runs every page; per group of 8 planes it loads one word a plane,
//   transposes the 8 x 8 bit matrix of each byte lane by three stages of
//   row swaps and joins high and low bytes into bf16 pairs with byte
//   permutes, writing K and V tiles (bf16, head-major, zero-padded to 16
//   dims; rows of an odd number of 16-byte chunks and each head one chunk
//   further on, so that neither the stores nor ldmatrix meet on a bank)
//   into one of three buffers, so the rebuild may run two pages ahead.  The
//   rebuild warps meet at one named barrier a page; tiles pass to the
//   compute warps through mbarriers.
// - Products and softmax: each compute warp, on the tensor cores
//   (mma.sync.m16n8k16 bf16 -> float32, operands by ldmatrix): scores as
//   q x K^T, the online softmax in registers (each row's max and sum across
//   the 4 lanes that hold it), p rounded to bf16 and fed straight back as
//   the A operand of p x V.  Products of bf16 values are exact in float32;
//   only the order of the float32 sums differs from the plain version.
// - Merge: with more than one split, each block writes its (acc, m, l) to a
//   workspace (a block with no live page writes only m = -1e30, l = 0, and
//   its acc is never read), and a second kernel, launched by the same call,
//   merges the splits: one warp per output row, every load issued before
//   any is used, splits added in a fixed order (a call repeats bit for
//   bit).  It normalises (fused; rows with nothing valid 0) or writes the
//   merged (o, m, l) (rung).
//
// Measured limits (chip_smoke.py phase 6 on an H100; numbers in PERF.md
// section 6): the bit rebuild and the products, not HBM, hold a page step,
// so a long cold call at Yi-9B's head shape reaches about a third of its
// byte bound at keep 8 and half at keep 16; a call also pays a fixed start
// (the live-page scan, then the first loads) and the merge kernel, which at
// the serving shape are most of its time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPage = 16;
constexpr int kBits = 16;
constexpr float kNegInf = -1e30f;
// rebuild warps of a block: 7 where two blocks share an SM (up to 64
// dims), 11 where one block has it
template <int HD16>
__host__ __device__ constexpr int rebuild_warps() { return HD16 <= 64 ? 7 : 11; }
constexpr int kMaxItems = 4;  // compute warps a block: (kv head, 16 query rows) tiles
constexpr int kMaxStages = 8;
constexpr int kTileBufs = 3;  // K/V tile buffers: the rebuild runs up to 2 pages ahead
constexpr int kBarrierBytes = 256;  // (2 kMaxStages + 2 kTileBufs) mbarriers, 8 bytes each
constexpr int kMergeLoads = 16;  // acc loads a lane issues at once in the merge
constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 64;
constexpr int kMaxUnits = 4;  // rebuild units (words of a plane run) a rebuild thread
constexpr int kSmemMax = 227 * 1024;
static_assert((2 * kMaxStages + 2 * kTileBufs) * 8 <= kBarrierBytes,
              "the mbarriers fit before the tiles");

struct Geo {
  int B, S, Hkv, rep, hd;
  int hd16;     // the instantiated tile width: hd rounded up to 16, 32, 64, 128 or 256
  int heads;    // kv heads a block
  int qtiles;   // 16-row query tiles a block, per head
  int qgroups;  // query groups: ceil(ceil(rep / 16) / qtiles)
  int pps;      // pages a split
  int splits;
  int planes;   // planes a ring stage holds for K and for V
  int stages;
  int rung_keep;
  float scale;
};

// Shared memory: mbarriers | two K/V tile buffers | the compute warps'
// query tiles | the ring of plane stages | live-page masks | live pages.
struct Layout {
  int ld;          // tile row, bf16 values
  int head;        // a head's 16 rows in a tile, and 8 values more, so that
                   // the heads' rows start on other banks
  int tile_elems;  // one buffer: K then V, heads x 16 rows x ld
  int run;         // bytes of one plane of one page for the block's heads
  int slot;        // bytes of one ring stage
  int off_tiles, off_q, off_ring, off_mask, off_list, total;
};

__host__ __device__ inline Layout layout(const Geo& g, int stages) {
  Layout L;
  L.ld = g.hd16 + 8;  // an odd number of 16-byte chunks a row
  L.head = kPage * L.ld + 8;
  L.tile_elems = 2 * g.heads * L.head;
  L.run = kPage * g.heads * (g.hd / 8);
  L.slot = 2 * g.planes * L.run;
  L.off_tiles = kBarrierBytes;
  L.off_q = (L.off_tiles + kTileBufs * L.tile_elems * 2 + 127) / 128 * 128;  // TMA: 128-aligned
  L.off_ring = L.off_q + g.heads * g.qtiles * kPage * L.ld * 2;
  L.off_mask = L.off_ring + stages * L.slot;
  L.off_list = L.off_mask + g.pps * 16;
  L.total = L.off_list + g.pps * 8;
  return L;
}

// floor(n / d) for n * d < 2^32, from m = ceil(2^32 / d)
struct FastDiv {
  uint64_t m;
  __device__ explicit FastDiv(uint32_t d) : m((uint64_t)(0xFFFFFFFFu / d) + 1) {}
  __device__ uint32_t operator()(uint32_t n) const { return (uint32_t)((n * m) >> 32); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(VEC));
  }
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive now (release: this thread's plain stores are seen by the waiters).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Expect `bytes` more on bar, and arrive (a barrier of count 1).
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA tensor maps of the K and V planes, each viewed as (W bytes, rows of
// W bytes, 16 planes): a page's plane run is `rows` rows, and map i copies
// 2^i planes of it in one operation.  rows = 0: no maps (cp.async).
struct PlaneMaps {
  CUtensorMap k[5], v[5];
  int rows;
};

// One TMA copy through `map` of the box at (row c1, plane c2) into dst,
// completing its bytes on bar.
__device__ __forceinline__ void tma_planes(void* dst, const CUtensorMap* map, int c1, int c2,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// (a ^ b) & c in one lop3
__device__ __forceinline__ uint32_t xor_and(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x28;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}


// Rows a and b of 8 x 8 bit matrices (one in each byte) trade the bits of
// b under mask m for the bits S places above them in a.
template <int S>
__device__ __forceinline__ void swap_rows(uint32_t& a, uint32_t& b, uint32_t m) {
  const uint32_t t = xor_and(a >> S, b, m);
  b ^= t;
  a ^= t << S;
}

// Planes p0 .. p0 + 7 of 4 neighbouring byte columns (one 4-byte word a
// plane, `stride` bytes apart; planes at or past keep read as 0) -> t[c],
// c = 0..7: byte j of t[c] holds, MSB first, the group's 8 bits of value
// 7 - c of byte column j.  Each byte lane of the 8 words is an 8 x 8 bit
// matrix (row r = plane p0 + 7 - r), transposed in three stages of row
// swaps: 12 swaps of 5 instructions for the 32 values.
__device__ __forceinline__ void rebuild_group(const uint8_t* src, int stride, int p0, int keep,
                                              uint32_t t[8]) {
  if (keep >= p0 + 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      t[r] = *reinterpret_cast<const uint32_t*>(src + (p0 + 7 - r) * stride);
  } else {  // every load issued (a plane past keep reads plane keep - 1), then zeroed
#pragma unroll
    for (int r = 0; r < 8; ++r)
      t[r] = *reinterpret_cast<const uint32_t*>(src + min(p0 + 7 - r, keep - 1) * stride);
#pragma unroll
    for (int r = 0; r < 8; ++r) t[r] = p0 + 7 - r < keep ? t[r] : 0u;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) swap_rows<4>(t[r], t[r + 4], 0x0F0F0F0Fu);
  swap_rows<2>(t[0], t[2], 0x33333333u);
  swap_rows<2>(t[1], t[3], 0x33333333u);
  swap_rows<2>(t[4], t[6], 0x33333333u);
  swap_rows<2>(t[5], t[7], 0x33333333u);
#pragma unroll
  for (int r = 0; r < 8; r += 2) swap_rows<1>(t[r], t[r + 1], 0x55555555u);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b for one 16 x 8 x 16 tile (a row-major, b column-major).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// This thread's rebuild units (a 4-byte word of a K or V plane run of the
// page; its 4 byte columns give 32 values), N of them, rebuilt together so
// that their plane loads and row swaps interleave: src[i] is the word's
// offset in a stage, dst[i][j] byte column j's offset in a tile buffer.
// Values 2e and 2e + 1 of a column come from words 7 - 2e and 6 - 2e of the
// transposed groups: the high byte from planes 0-7, the low from 8-15 (0 at
// keep <= 8).
template <int N>
__device__ __forceinline__ void rebuild_units(const uint8_t* stage, bf16* tile, int run, int keep,
                                              const int* src, const int (*dst)[4]) {
  uint32_t hi[N][8];
#pragma unroll
  for (int i = 0; i < N; ++i) rebuild_group(stage + src[i], run, 0, keep, hi[i]);
  if (keep > 8) {
    uint32_t lo[N][8];
#pragma unroll
    for (int i = 0; i < N; ++i) rebuild_group(stage + src[i], run, 8, keep, lo[i]);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of word a in byte 0, of word b in byte 2
        const uint32_t sel = j | j << 4 | (4 + j) << 8 | (4 + j) << 12;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = prmt(prmt(lo[i][7 - 2 * e], lo[i][6 - 2 * e], sel),
                      prmt(hi[i][7 - 2 * e], hi[i][6 - 2 * e], sel), 0x6240);
        *reinterpret_cast<uint4*>(tile + dst[i][j]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of word a in byte 1, of word b in byte 3; low bytes 0
        const uint32_t sel = j | j << 4 | j << 8 | (4 + j) << 12;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = prmt(hi[i][7 - 2 * e], hi[i][6 - 2 * e], sel) & 0xFF00FF00u;
        *reinterpret_cast<uint4*>(tile + dst[i][j]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
  }
}

// Warp roles: rebuild_warps<HD16>() rebuild warps (warp 0 also lists the
// live pages), one producer warp (its lane 0 issues the plane loads by TMA,
// one tensor copy per power of two in a page's keep, K and V), then one
// compute warp per (kv head, query tile) of the block.  Two blocks an SM up
// to 64 dims, one above.
template <int HD16, bool kFused>
__global__ void __launch_bounds__(32 * (rebuild_warps<HD16>() + 1 + kMaxItems),
                                  HD16 <= 64 ? 2 : 1)
    paged_attention_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ kp,
                           const uint8_t* __restrict__ vp, const int32_t* __restrict__ page_keeps,
                           const int8_t* __restrict__ mask, float* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out,
                           float* __restrict__ ws, const Geo g,
                           const __grid_constant__ PlaneMaps maps) {
  constexpr int LD = HD16 + 8;
  constexpr int KS = HD16 / 16;  // k-steps of q . k
  constexpr int NT = HD16 / 8;   // 8-column tiles of p . v
  constexpr int kRebuildWarps = rebuild_warps<HD16>();
  constexpr int kRebuildThreads = 32 * kRebuildWarps;
  constexpr int kProducer = kRebuildWarps;  // the producer warp
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int n_live_s;

  const Layout L = layout(g, g.stages);
  const int split = blockIdx.x, b = blockIdx.y;
  const int hgroups = g.Hkv / g.heads;
  const int hg = blockIdx.z % hgroups, qg = blockIdx.z / hgroups;
  const int G = g.heads, hd = g.hd, hd8 = hd / 8, rep = g.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int items = nthreads / 32 - kRebuildWarps - 1;  // compute warps
  const bool rebuilder = warp < kRebuildWarps;
  const bool computer = warp > kProducer;
  const int n_pages = g.S / kPage;
  const int p_lo = split * g.pps, p_hi = min(n_pages, p_lo + g.pps);
  const bool tma = maps.rows > 0;  // else cp.async from the rebuild threads

  // mbarriers: ring stages full | ring stages free | tiles full | tiles free
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* tfull = empty + kMaxStages;
  uint64_t* tfree = tfull + kTileBufs;
  bf16* tiles = reinterpret_cast<bf16*>(smem + L.off_tiles);
  uint8_t* ring = smem + L.off_ring;
  uint4* live_mask = reinterpret_cast<uint4*>(smem + L.off_mask);
  int2* live = reinterpret_cast<int2*>(smem + L.off_list);

  // TMA: page k's kept planes into stage k % stages, one copy per power of
  // two in its keep for K and for V
  auto issue_tma = [&](int k) {
    const int slot = k % g.stages;
    const int2 pk = live[k];
    const int keep = pk.y;
    arrive_expect_tx(full + slot, 2 * keep * L.run);
    uint8_t* dst = ring + slot * L.slot;
    const int row = (b * n_pages + pk.x) * maps.rows;
    int p0 = 0;
#pragma unroll
    for (int i = 4; i >= 0; --i) {  // planes [p0, p0 + 2^i) for each set bit of keep
      if (!(keep >> i & 1)) continue;
      tma_planes(dst + p0 * L.run, &maps.k[i], row, p0, full + slot);
      tma_planes(dst + (g.planes + p0) * L.run, &maps.v[i], row, p0, full + slot);
      p0 += 1 << i;
    }
  };

  // 1. warp 0: the range's live pages in page order, the barriers, and (TMA)
  // the first stages' loads
  if (warp == 0) {
    int count = 0;
    for (int base = p_lo; base < p_hi; base += 32) {
      const int p = base + lane;
      int keep = 0;
      uint4 mk = make_uint4(0u, 0u, 0u, 0u);
      if (p < p_hi) {
        keep = kFused ? page_keeps[(size_t)b * n_pages + p] : g.rung_keep;
        keep = min(keep, kBits);
        mk = *reinterpret_cast<const uint4*>(mask + (size_t)b * g.S + (size_t)p * kPage);
      }
      const uint32_t any = __vcmpgts4(mk.x, 0u) | __vcmpgts4(mk.y, 0u) |
                           __vcmpgts4(mk.z, 0u) | __vcmpgts4(mk.w, 0u);
      const bool on = p < p_hi && keep > 0 && any != 0u;
      const uint32_t bal = __ballot_sync(0xffffffffu, on);
      if (on) {
        const int k = count + __popc(bal & ((1u << lane) - 1u));
        live[k] = make_int2(p, keep);
        live_mask[k] = mk;
      }
      count += __popc(bal);
    }
    if (lane == 0) {
      n_live_s = count;
      for (int s = 0; s < g.stages; ++s) {
        barrier_init(full + s, tma ? 1 : kRebuildThreads);
        barrier_init(empty + s, 1);
      }
      for (int j = 0; j < kTileBufs; ++j) {
        barrier_init(tfull + j, 1);
        barrier_init(tfree + j, items);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (tma)
        for (int k = 0; k < min(count, g.stages); ++k) issue_tma(k);
    }
  }

  // 2. tiles zeroed (the columns past hd must read as 0); a compute warp's
  // 16 query rows, bf16, zero past rep and hd (the A operand of q . K^T,
  // read by ldmatrix each page)
  for (int i = tid; i < kTileBufs * L.tile_elems / 8; i += nthreads)
    reinterpret_cast<uint4*>(tiles)[i] = make_uint4(0u, 0u, 0u, 0u);
  const int item = computer ? warp - kProducer - 1 : 0;
  const int hl = item / g.qtiles;                 // the warp's head in the group
  const int qt = qg * g.qtiles + item % g.qtiles;  // and its query tile
  const bool active = computer && qt * 16 < rep;
  const int h = hg * G + hl;
  const int gr = lane >> 2, gc = lane & 3;  // mma fragment row and column pair
  const int r0 = qt * 16 + gr, r1 = r0 + 8;
  bf16* qtile = reinterpret_cast<bf16*>(smem + L.off_q) + item * kPage * LD;
  if (computer) {  // 4-byte loads, all issued before any is stored
    constexpr int kPer = kPage * HD16 / 2 / 32;  // words a lane
    const bf16* qrow = q + ((size_t)b * g.Hkv + h) * rep * hd;
    uint32_t qw[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = lane + 32 * i, r = x / (HD16 / 2), d = 2 * (x % (HD16 / 2));
      const int rr = qt * 16 + r;
      qw[i] = active && rr < rep && d < hd
                  ? *reinterpret_cast<const uint32_t*>(qrow + (size_t)rr * hd + d)
                  : 0u;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = lane + 32 * i, r = x / (HD16 / 2), d = 2 * (x % (HD16 / 2));
      *reinterpret_cast<uint32_t*>(qtile + r * LD + d) = qw[i];
    }
  }
  // a rebuild thread's units, the same every page (worked out while the
  // first loads are in flight); units go to the last threads first, so
  // that thread 0, which hands each page on, has the fewest
  const int nwords = L.run / 4;
  int src[kMaxUnits], dst[kMaxUnits][4], nu = 0;
  if (rebuilder) {
    // quotients by float reciprocals, exact for these small operands
    const float inv_tok = 1.f / (G * hd8), inv_hd8 = 1.f / hd8;
#pragma unroll
    for (int i = 0; i < kMaxUnits; ++i) {
      const int u = kRebuildThreads - 1 - tid + i * kRebuildThreads;
      const int kv = u >= nwords, w = u - kv * nwords;
      src[i] = kv * g.planes * L.run + 4 * w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = 4 * w + j;
        const int t = (int)((byte + 0.5f) * inv_tok), rest = byte - t * G * hd8;
        const int hw = (int)((rest + 0.5f) * inv_hd8);
        dst[i][j] = (kv * G + hw) * L.head + t * LD + 8 * (rest - hw * hd8);
      }
      nu += u < 2 * nwords;
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  __syncthreads();
  const int n_live = n_live_s;

  // 3. the page loop: the producer fills the ring, rebuild warps turn
  // stages into tiles, compute warps multiply; stages pass from producer
  // to rebuild warps through full / empty, tiles k % 3 from rebuild to
  // compute warps through tfull / tfree
  if (warp == kProducer) {  // the loads past the first stages
    if (!tma || lane != 0) return;
    for (int k = g.stages; k < n_live; ++k) {
      wait_phase(empty + k % g.stages, (uint32_t)(k / g.stages - 1) & 1u);
      issue_tma(k);
    }
    return;
  }
  if (rebuilder) {

    // cp.async (no TMA): every rebuild thread copies chunks of vec bytes of
    // the page's planes (rows of a head group's heads, each token apart)
    const size_t plane_stride = (size_t)g.B * g.S * g.Hkv * hd8;
    const int seg = G == g.Hkv ? L.run : G * hd8;  // contiguous bytes of a plane
    const int vec = seg % 16 == 0 ? 16 : seg % 8 == 0 ? 8 : seg % 4 == 0 ? 4 : 1;
    const int chunks = L.run / vec, seg_chunks = seg / vec;
    auto issue = [&](int k) {
      const FastDiv div_chunks(chunks), div_seg(seg_chunks);
      const int slot = k % g.stages;
      uint8_t* dst_ = ring + slot * L.slot;
      const int2 pk = live[k];
      const int keep = pk.y;
      const size_t page_off =
          (((size_t)b * g.S + (size_t)pk.x * kPage) * g.Hkv + hg * G) * hd8;
      for (int e = tid; e < 2 * keep * chunks; e += kRebuildThreads) {
        const int pi = div_chunks(e), c = e - pi * chunks;
        const int kv = pi >= keep, i = pi - kv * keep;
        const int t = div_seg(c), cc = c - t * seg_chunks;
        const uint8_t* from =
            (kv ? vp : kp) + i * plane_stride + page_off + (size_t)t * g.Hkv * hd8 + cc * vec;
        uint8_t* to = dst_ + (kv * g.planes + i) * L.run + c * vec;
        switch (vec) {
          case 16: copy_async<16>(to, from); break;
          case 8: copy_async<8>(to, from); break;
          case 4: copy_async<4>(to, from); break;
          default: *to = *from;
        }
      }
      if (vec == 1)
        arrive(full + slot);
      else
        arrive_on_copies(full + slot);
    };
    if (!tma)
      for (int k = 0; k < min(n_live, g.stages); ++k) issue(k);

    for (int k = 0; k < n_live; ++k) {
      if (k >= kTileBufs)
        wait_phase(tfree + k % kTileBufs, (uint32_t)(k / kTileBufs - 1) & 1u);
      wait_phase(full + k % g.stages, (uint32_t)(k / g.stages) & 1u);
      const uint8_t* stage = ring + (k % g.stages) * L.slot;
      bf16* tile = tiles + k % kTileBufs * L.tile_elems;
      const int keep = live[k].y;
      switch (nu) {
        case 1: rebuild_units<1>(stage, tile, L.run, keep, src, dst); break;
        case 2: rebuild_units<2>(stage, tile, L.run, keep, src, dst); break;
        case 3: rebuild_units<3>(stage, tile, L.run, keep, src, dst); break;
        case 4: rebuild_units<4>(stage, tile, L.run, keep, src, dst); break;
        default: break;
      }
      // every rebuild thread is done with stage k and with tiles k
      asm volatile("bar.sync 1, %0;\n" ::"n"(kRebuildThreads) : "memory");
      if (tid == 0) {
        arrive(tfull + k % kTileBufs);
        if (tma) arrive(empty + k % g.stages);
      }
      if (!tma && k + g.stages < n_live) issue(k + g.stages);
    }
    return;
  }

  for (int k = 0; k < n_live; ++k) {
    wait_phase(tfull + k % kTileBufs, (uint32_t)(k / kTileBufs) & 1u);
    if (active) {
      const bf16* kt = tiles + k % kTileBufs * L.tile_elems + hl * L.head;
      const bf16* vt = kt + G * L.head;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, qtile + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + ks * 16 +
                            (lane >> 4) * 8);
        ldmatrix_x4(kb, kt + (((lane >> 4) << 3) + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma16816(s[0], qa, kb[0], kb[1]);
        mma16816(s[1], qa, kb[2], kb[3]);
      }
      // s[nt][e]: row gr (e < 2) or gr + 8, token nt * 8 + 2 gc + (e & 1)
      const int8_t* mk = reinterpret_cast<const int8_t*>(live_mask + k);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = mk[nt * 8 + 2 * gc + (e & 1)] > 0 ? s[nt][e] * g.scale : kNegInf;
      const float mx0 =
          quad_max(fmaxf(m0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]))));
      const float mx1 =
          quad_max(fmaxf(m1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]))));
      const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        p[nt][0] = expf(s[nt][0] - mx0);
        p[nt][1] = expf(s[nt][1] - mx0);
        p[nt][2] = expf(s[nt][2] - mx1);
        p[nt][3] = expf(s[nt][3] - mx1);
      }
      l0 = l0 * c0 + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
      l1 = l1 * c1 + ((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
      m0 = mx0;
      m1 = mx1;
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {  // a row's max moved
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][0] *= c0;
          acc[nt][1] *= c0;
          acc[nt][2] *= c1;
          acc[nt][3] *= c1;
        }
      }
      // p rounded to bf16 (the reference's p.astype(bf16) before p . v)
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + np * 16 +
                                  (lane >> 4) * 8);
        mma16816(acc[2 * np], pa, vb[0], vb[1]);
        mma16816(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();
    if (lane == 0) arrive(tfree + k % kTileBufs);
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // 4. out, or this split's partial for the merge kernel
  const size_t row_base = ((size_t)b * g.Hkv + h) * rep;  // (b, h, row 0)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rep) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (g.splits == 1) {
      const bool any = m > kNegInf * 0.5f;
      float* orow = out + (row_base + r) * hd;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + 2 * gc;
        if (d >= hd) continue;
        float2 o = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        if (kFused) {
          const float inv = 1.f / fmaxf(l, 1e-30f);
          o = any ? make_float2(o.x * inv, o.y * inv) : make_float2(0.f, 0.f);
        }
        *reinterpret_cast<float2*>(orow + d) = o;
      }
      if (!kFused && gc == 0) {
        m_out[row_base + r] = m;
        l_out[row_base + r] = l;
      }
    } else {
      // a split with no live page writes m = -1e30, l = 0 and no acc
      const size_t n_rows = (size_t)g.B * g.Hkv * rep;  // rows of one split's partial
      float* ws_ml = ws + (size_t)g.splits * n_rows * hd;
      const size_t row = (size_t)split * n_rows + row_base + r;
      if (n_live > 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = nt * 8 + 2 * gc;
          if (d < hd)
            *reinterpret_cast<float2*>(ws + row * hd + d) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
      }
      if (gc == 0) *reinterpret_cast<float2*>(ws_ml + 2 * row) = make_float2(m, l);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The splits' partials merged, one warp per output row (b, h, r).  Every
// load is issued before any is used: each lane loads the m and l of splits
// lane and lane + 32 and the acc of its column for up to kMergeLoads splits
// (`lpc` lanes share a column, taking every lpc-th split), so the partials
// cost one round trip to memory.  Weights exp(m_s - max) are 0 for a split
// with no live page, whose acc was never written and is not added (a
// select, not a product).  A lane adds its splits in order, then the lanes
// of a column add theirs by shuffles in a fixed order.  Fused: normalised, a
// row with nothing valid written as 0; rung: the merged (o, m, l).
template <bool kFused>
__global__ void __launch_bounds__(kMergeThreads)
    paged_attention_merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                 float* __restrict__ m_out, float* __restrict__ l_out,
                                 int n_rows, int hd, int splits) {
  __shared__ float weight[kMergeThreads / 32][kMaxSplits];
  const int row = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float* wrow = weight[threadIdx.x >> 5];
  const float* ml = ws + (size_t)splits * n_rows * hd;
  const int hd4 = hd / 4;
  int lpc = 1;  // lanes a column: the largest power of two with hd4 * lpc <= 32
  while (2 * lpc * hd4 <= 32) lpc *= 2;
  const int j = lane % lpc, cols = 32 / lpc;  // columns a pass
  const int passes = (hd4 + cols - 1) / cols;
  auto load = [&](float4* v, int c, int s0) {
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      const int s = s0 + j + u * lpc;
      v[u] = s < splits && c < hd4
                 ? __ldg(reinterpret_cast<const float4*>(ws + ((size_t)s * n_rows + row) * hd) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float4 v[kMergeLoads];
  load(v, lane / lpc, 0);
  float ms[2] = {kNegInf, kNegInf}, ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = lane + 32 * i;
    if (s < splits) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(ml + 2 * ((size_t)s * n_rows + row)));
      ms[i] = x.x;
      ls[i] = x.y;
    }
  }
  const float mx = warp_max(fmaxf(ms[0], ms[1]));
  float wl = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float w = ms[i] > kNegInf * 0.5f ? expf(ms[i] - mx) : 0.f;
    if (lane + 32 * i < splits) wrow[lane + 32 * i] = w;
    wl += ls[i] * w;
  }
  const float lsum = warp_sum(wl);
  __syncwarp();
  const float inv = kFused && mx > kNegInf * 0.5f ? 1.f / fmaxf(lsum, 1e-30f) : 0.f;
  for (int pass = 0; pass < passes; ++pass) {
    const int c = lane / lpc + pass * cols;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kMergeLoads * lpc) {
      if (pass > 0 || s0 > 0) load(v, c, s0);
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        const int s = s0 + j + u * lpc;
        const float w = s < splits ? wrow[s] : 0.f;
        if (w != 0.f) {
          a.x = fmaf(w, v[u].x, a.x);
          a.y = fmaf(w, v[u].y, a.y);
          a.z = fmaf(w, v[u].z, a.z);
          a.w = fmaf(w, v[u].w, a.w);
        }
      }
    }
    for (int o = 1; o < lpc; o *= 2) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
    }
    if (j == 0 && c < hd4) {
      if (kFused) a = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      reinterpret_cast<float4*>(out + (size_t)row * hd)[c] = a;
    }
  }
  if (!kFused && lane == 0) {
    m_out[row] = mx;
    l_out[row] = lsum;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime (no link to libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The K and V maps for page runs of `run` bytes (a multiple of 128): boxes
// of 1, 2, 4, 8 and 16 planes, or only those a rung's keep needs.
int encode_maps(PlaneMaps* maps, const void* kp, const void* vp, const Geo& g, int run,
                int rung_keep) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int w = run % 256 == 0 ? 256 : 128;
  const cuuint64_t plane = (cuuint64_t)g.B * g.S * g.Hkv * (g.hd / 8);
  const cuuint64_t dims[3] = {(cuuint64_t)w, plane / w, (cuuint64_t)kBits};
  const cuuint64_t strides[2] = {(cuuint64_t)w, plane};
  const cuuint32_t step[3] = {1, 1, 1};
  for (int i = 0; i < 5; ++i) {
    if (rung_keep > 0 && !(rung_keep >> i & 1)) continue;
    const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)(run / w), 1u << i};
    for (int kv = 0; kv < 2; ++kv)
      if (encode(kv ? &maps->v[i] : &maps->k[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                 const_cast<void*>(kv ? vp : kp), dims, strides, box, step,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
  }
  maps->rows = run / w;
  return 0;
}

template <int HD16, bool kFused>
int launch_hd(const void* q, const void* kp, const void* vp, const void* keeps,
              const void* mask, void* out, void* m_out, void* l_out, void* ws, Geo g,
              cudaStream_t stream) {
  auto kernel = paged_attention_kernel<HD16, kFused>;
  constexpr int kRebuildWarps = rebuild_warps<HD16>();
  g.hd16 = HD16;
  if (8 * g.heads * (g.hd / 8) > kMaxUnits * 32 * kRebuildWarps) return (int)cudaErrorInvalidValue;
  // stages: as many as fit beside the tiles (in half an SM's shared memory
  // where two blocks share an SM), up to the pages of a split
  const int budget = HD16 <= 64 ? kSmemMax / 2 - 1024 : kSmemMax;
  const Layout fixed = layout(g, 0);
  int stages = (budget - fixed.total) / fixed.slot;
  stages = stages < kMaxStages ? stages : kMaxStages;
  stages = stages < g.pps ? stages : g.pps;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  g.stages = stages;
  const int smem = layout(g, stages).total;
  // TMA where every head is in the block and a page's plane run is a
  // multiple of 128 bytes (stage offsets stay 128-byte aligned)
  PlaneMaps maps{};
  if (g.heads == g.Hkv && fixed.run % 128 == 0) {
    const int err = encode_maps(&maps, kp, vp, g, fixed.run, kFused ? 0 : g.rung_keep);
    if (err) return err;
  }
  // the attribute is per device: set it once per device to the largest size
  static int set[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && smem > set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set[dev] = smem;
  }
  const dim3 grid(g.splits, g.B, (g.Hkv / g.heads) * g.qgroups);
  const int threads = 32 * (kRebuildWarps + 1 + g.heads * g.qtiles);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(kp),
      static_cast<const uint8_t*>(vp), static_cast<const int32_t*>(keeps),
      static_cast<const int8_t*>(mask), static_cast<float*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(ws), g, maps);
  if (g.splits > 1) {
    const int n_rows = g.B * g.Hkv * g.rep;
    const int per_block = kMergeThreads / 32;
    paged_attention_merge_kernel<kFused>
        <<<(n_rows + per_block - 1) / per_block, kMergeThreads, 0, stream>>>(
            static_cast<const float*>(ws), static_cast<float*>(out), static_cast<float*>(m_out),
            static_cast<float*>(l_out), n_rows, g.hd, g.splits);
  }
  return (int)cudaGetLastError();
}

template <bool kFused>
int launch(const void* q, const void* kp, const void* vp, const void* keeps, const void* mask,
           void* out, void* m_out, void* l_out, void* ws, int B, int S, int Hkv, int rep, int hd,
           int heads, int qtiles, int qgroups, int pps, int splits, int rung_keep, float scale,
           void* stream) {
  if (hd % 8 != 0 || hd > 256 || S % kPage != 0 || heads < 1 || Hkv % heads != 0 ||
      heads * qtiles > kMaxItems || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  Geo g{B, S, Hkv, rep, hd, 0, heads, qtiles, qgroups, pps, splits,
        kFused ? kBits : rung_keep, 0, rung_keep, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((hd + 15) / 16 * 16) {
    case 16: return launch_hd<16, kFused>(q, kp, vp, keeps, mask, out, m_out, l_out, ws, g, st);
    case 32: return launch_hd<32, kFused>(q, kp, vp, keeps, mask, out, m_out, l_out, ws, g, st);
    case 48:
    case 64: return launch_hd<64, kFused>(q, kp, vp, keeps, mask, out, m_out, l_out, ws, g, st);
    case 80:
    case 96:
    case 112:
    case 128: return launch_hd<128, kFused>(q, kp, vp, keeps, mask, out, m_out, l_out, ws, g, st);
    default: return launch_hd<256, kFused>(q, kp, vp, keeps, mask, out, m_out, l_out, ws, g, st);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); an argument
// the kernels do not take returns cudaErrorInvalidValue.  With more than
// one split, `ws` holds splits x B x Hkv x rep x (hd + 2) floats (the
// splits' partials) and a second kernel merges them.
int paged_attention_fused_launch(const void* q, const void* kp, const void* vp,
                                 const void* page_keeps, const void* mask, void* out, void* ws,
                                 int B, int S, int Hkv, int rep, int hd, int heads, int qtiles,
                                 int qgroups, int pps, int splits, float scale, void* stream) {
  return launch<true>(q, kp, vp, page_keeps, mask, out, nullptr, nullptr, ws, B, S, Hkv, rep, hd,
                      heads, qtiles, qgroups, pps, splits, 0, scale, stream);
}

int paged_attention_rung_launch(const void* q, const void* kp, const void* vp, const void* mask,
                                void* out, void* m_out, void* l_out, void* ws, int B, int S,
                                int Hkv, int rep, int hd, int heads, int qtiles, int qgroups,
                                int pps, int splits, int keep, float scale, void* stream) {
  if (keep < 1 || keep > kBits) return (int)cudaErrorInvalidValue;
  return launch<false>(q, kp, vp, nullptr, mask, out, m_out, l_out, ws, B, S, Hkv, rep, hd,
                       heads, qtiles, qgroups, pps, splits, keep, scale, stream);
}


}  // extern "C"
