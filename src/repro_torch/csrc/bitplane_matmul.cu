// Matrix product with bit-plane weights, for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/bitplane_matmul/kernel.py (bitplane_matmul, _kernel):
// x (M, K) bf16 times a weight W (K, N) stored as bit-planes, W rebuilt
// inside the kernel from its top `keep` planes (the low planes read as 0),
// float32 accumulation.  The rebuilt weight never goes to device memory and
// no plane at or past `keep` is read.
//
// Layouts (the reference's, unchanged):
//   x       (M, K)          bf16, row-major
//   planes  (bits, K, N/8)  uint8; bit i (0 = MSB) of W[k][n] sits in
//                           planes[i][k][n/8] at bit 7 - n%8; W's values
//                           are bf16 patterns of `bits` <= 16 bits
//   out     (M, N)          float32
// Any M and K; N % 8 == 0; 0 <= keep <= bits (keep 0 gives zeros, or NaN
// where x holds a NaN, as the plain version).
//
// What bounds it on this card: bytes.  A call must read keep * K * N / 8
// plane bytes; the product is 2 * M * K * N operations, i.e. 16 M / keep
// per plane byte: at M = 8 far below the 295 the card needs before its
// tensor cores are the limit, at M = 128, keep 8 near it (256).  The second
// bound is the rebuild, an integer pass over every weight value.
//
// Two paths, chosen by the wrapper (kernel.py: plan):
//
// The decode path (M <= 32, N % 128 == 0, K % 8 == 0, keep > 0):
// - Grid: one block per (512-column tile, K split); K is cut into the
//   number of splits (of a multiple of 32 rows) whose blocks fill whole
//   waves of 2 blocks per SM best: the Zamba2-7B MLP up-projection
//   (3584 x 14336) runs 28 tiles x 9 splits of 416 rows = 252 blocks.
// - Warp roles: 8 consumer warps and 1 producer warp.  The producer's lane
//   0 loads the kept planes' (keep, 32 rows, 64 bytes) box of each K tile
//   by TMA (a 3-D tensor map over (bits, K, N/8), 64-byte swizzle) into a
//   ring of stages sized to 112 KB of shared memory with the rest (3 stages
//   at keep 8, 2 at keep 16 on that shape; up to 16), behind full and empty
//   mbarriers.  The block loads its x chunk (16 MT rows by the split's rows,
//   bf16) once.  No block-wide barrier runs inside the K loop.
// - Consumer warp w owns columns [64 w, 64 w + 64): each lane rebuilds rows
//   r and r + 16 of the tile at 4 plane bytes (32 columns), releases the
//   stage, writes the bf16 values into the warp's own tile in shared memory
//   and multiplies it (two k-steps) into float32 accumulators.
//
// The general path (any other shape): one block per (128-column tile, K
// split, slab of 16 MT rows), 256 threads, 64-row K tiles in a ring of
// stages (TMA where N % 128 == 0, else plain byte loads), one
// __syncthreads a tile, the W tile double-buffered; splits give at least 264 blocks where K
// allows.  It serves M > 32 (slabs of 64 or 128 rows: MT 4 or 8) and the
// quickstart's (1024, 1024).
//
// Rebuild (both paths): per group of 8 planes (the planes that make a
// value's high byte, then its low byte) a lane reads 8 words (one per
// plane, 4 byte columns), turns them into one 8 x 8 bit matrix per byte
// column with two 4 x 4 byte transposes (8 prmt each), transposes each
// matrix (Hacker's Delight transpose8 on two 32-bit words: 3 delta swaps,
// shift + lop3 + shift + lop3 per word, 21 instructions), joins high and low
// bytes into bf16 pairs (4 prmt per 8 values) and stores them, 16 bytes at
// a time.  Integer instructions per weight value, counted from this
// source: 4.0 where keep + 16 - bits <= 8 (one group), 7.4 above (two
// groups).  Planes outside [0, keep) are never read: the general path
// tests the plane index, the decode path reads zeroed slots.
//
// Product: tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> float32 for
// every M, x padded to 16 MT rows (MT 1 for M <= 16, 2 for <= 32 on the
// decode path; 4 and 8 for <= 64 and beyond on the general path); A by
// ldmatrix.x4, B by ldmatrix.x4.trans.  No wgmma: M >= 64 runs mma.sync on
// the general path.
//
// Reduction: with one split the block writes out; with more, each split
// writes its partial (M, N) float32 sum into a workspace and a second
// kernel (bitplane_matmul_reduce_kernel) adds the splits in order, so a
// result repeats run to run (no atomics).  Both kernels count in the
// kernel's device time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
// shared memory a block may take: two blocks fit on an SM (228 KB, 1 KB of
// it reserved per block)
constexpr int kSmemBudget = 112 * 1024;
constexpr int kSmemMax = 227 * 1024;

// The general path's tile: BN columns (BN / 8 plane bytes a row) by BK
// rows of K, so that the rebuild has one (row, 4 plane bytes) task per
// thread; each of the 8 warps owns BN / 8 columns (NT tiles of 8).
struct Tile {
  static constexpr int BN = 128;
  static constexpr int kBN8 = BN / 8;
  static constexpr int kBK = kThreads * 32 / BN;
  static constexpr int kQuads = BN / 32;     // 4-byte plane words a row
  static constexpr int kNT = BN / 64;        // n8 tiles a warp
  static constexpr int kXLd = kBK + 8;       // x slab row, bf16
  static constexpr int kWLd = BN + 8;        // W tile row, bf16
  static_assert(kBK % 16 == 0, "whole mma k-steps");
  // two barriers a stage, two W tiles; then per stage the kept planes' box
  // (a multiple of 1 KB: TMA destinations stay 128-byte aligned) and an x
  // slab
  static constexpr int fixed_smem() { return 2 * kMaxStages * 8 + 2 * kBK * kWLd * 2; }
  static constexpr int stage_smem(int mt, int keep) {
    return keep * kBK * kBN8 + 16 * mt * kXLd * 2;
  }
  static int stages(int mt, int keep) {
    const int s = (kSmemBudget - fixed_smem()) / stage_smem(mt, keep);
    return s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
  }
  static size_t smem(int mt, int keep) {
    return (size_t)fixed_smem() + (size_t)stages(mt, keep) * stage_smem(mt, keep);
  }
};
static_assert(Tile::fixed_smem() % 128 == 0,
              "plane boxes start 128-byte aligned");

// Offset of column n in a W tile row: 16-byte chunk c is stored at
// c ^ ((c >> 3) & 7), so that the rebuild's 16-byte stores (8 threads of a
// row, chunks 4 apart) fall on distinct banks; ldmatrix reads 8 rows of one
// chunk, on distinct banks through the row padding.
__device__ __forceinline__ int wcol(int n) {
  const int c = n >> 3;
  return ((c ^ ((c >> 3) & 7)) << 3) | (n & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `VEC` (16 or 1) bytes from global to shared memory; zeros where !ok.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool ok) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    *static_cast<uint8_t*>(dst) = ok ? *static_cast<const uint8_t*>(src) : 0;
  }
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive once this thread's cp.async copies so far have landed (a barrier
// of count kThreads).
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
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

// One TMA copy of the planes' (keep, BK, BN / 8) box at (byte column c0,
// row c1, plane 0) into dst, completing `bytes` on bar (a barrier of count
// 1: this arrival).
__device__ __forceinline__ void tma_planes(void* dst, const CUtensorMap* map, int c0, int c1,
                                           uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(0), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// 8 x 8 bit matrix, row r = byte (3 - r) of hi for r < 4, byte (7 - r) of
// lo for r >= 4, column c = bit 7 - c; transposed in place.
// (a ^ b) & c and a ^ b ^ c, one lop3 each
__device__ __forceinline__ uint32_t xor_and(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x28;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One delta swap: the bits of x under mask m and those `s` places above
// them trade places.
template <int S>
__device__ __forceinline__ uint32_t delta_swap(uint32_t x, uint32_t m) {
  const uint32_t t = xor_and(x >> S, x, m);
  return xor3(x, t, t << S);
}

__device__ __forceinline__ void transpose8(uint32_t& hi, uint32_t& lo) {
  hi = delta_swap<7>(hi, 0x00AA00AAu);
  lo = delta_swap<7>(lo, 0x00AA00AAu);
  hi = delta_swap<14>(hi, 0x0000CCCCu);
  lo = delta_swap<14>(lo, 0x0000CCCCu);
  const uint32_t t = xor_and(lo, hi << 4, 0xF0F0F0F0u);
  lo ^= t;
  hi ^= t >> 4;
}

// words w0..w3 (plane bytes for 4 neighbouring byte columns, column j in
// byte j) -> out[j]: column j's 4 plane bytes, w0's in the top byte.
__device__ __forceinline__ void bytes4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                         uint32_t out[4]) {
  const uint32_t u = prmt(w1, w0, 0x5140), v = prmt(w1, w0, 0x7362);
  const uint32_t u2 = prmt(w3, w2, 0x5140), v2 = prmt(w3, w2, 0x7362);
  out[0] = prmt(u2, u, 0x5410);
  out[1] = prmt(u2, u, 0x7632);
  out[2] = prmt(v2, v, 0x5410);
  out[3] = prmt(v2, v, 0x7632);
}

// One group of 8 planes (padded positions p0 .. p0 + 7, plane i = p - pad;
// planes outside [0, keep) read as 0; planes `stride` bytes apart) at this
// thread's 4 byte columns: hi[j], lo[j] = the transposed bit matrix of byte
// column j, row c holding value c's 8 bits of this group, MSB first.
__device__ __forceinline__ void rebuild_group(const uint8_t* src, int stride, int p0, int pad,
                                              int keep, uint32_t hi[4], uint32_t lo[4]) {
  uint32_t w[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int i = p0 + p - pad;
    w[p] = (i >= 0 && i < keep) ? *reinterpret_cast<const uint32_t*>(src + i * stride) : 0u;
  }
  bytes4x4(w[0], w[1], w[2], w[3], hi);
  bytes4x4(w[4], w[5], w[6], w[7], lo);
#pragma unroll
  for (int j = 0; j < 4; ++j) transpose8(hi[j], lo[j]);
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

// grid (column tiles, splits, x slabs); with more than one split, `out` is
// the (splits, M, N) workspace.  `tma`: the planes come by TMA through
// `map` (N % 128 == 0 and keep > 0), else by plain byte loads.
template <int VEC, int MT>
__global__ void __launch_bounds__(kThreads, 2)
    bitplane_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ planes,
                           const __grid_constant__ CUtensorMap map, float* __restrict__ out,
                           int M, int K, int N, int bits, int keep, int chunk, int x_vec,
                           int stages, int tma) {
  using T = Tile;
  constexpr int BN = T::BN;
  constexpr int kBK = T::kBK, kBN8 = T::kBN8, kXLd = T::kXLd, kWLd = T::kWLd;
  constexpr int MB = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full_x = reinterpret_cast<uint64_t*>(smem);               // [kMaxStages]
  uint64_t* full_p = full_x + kMaxStages;                             // [kMaxStages]
  bf16* ws = reinterpret_cast<bf16*>(smem + 2 * kMaxStages * 8);      // [2][kBK][kWLd]
  uint8_t* ps = reinterpret_cast<uint8_t*>(ws + 2 * kBK * kWLd);      // [stages][keep][kBK][kBN8]
  const int stage_planes = keep * kBK * kBN8;
  bf16* xs = reinterpret_cast<bf16*>(ps + stages * stage_planes);     // [stages][MB][kXLd]

  const int n8 = N / 8;
  const int nb0 = blockIdx.x * kBN8;
  const int k_lo = blockIdx.y * chunk;
  const int k_hi = min(K, k_lo + chunk);
  const int m0 = blockIdx.z * MB;
  const int tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto load_tile = [&](int t) {
    if (t >= tiles) return;
    const int slot = t % stages;
    const int kt = k_lo + t * kBK;
    uint8_t* pdst = ps + slot * stage_planes;
    if (tma) {
      if (tid == 0) tma_planes(pdst, &map, nb0, kt, full_p + slot, stage_planes);
    } else {
      constexpr int kChunks = kBN8 / VEC;
      const int total = keep * kBK * kChunks;
      for (int e = tid; e < total; e += kThreads) {
        const int c = e % kChunks, r = (e / kChunks) % kBK, i = e / (kChunks * kBK);
        const int gk = kt + r, gb = nb0 + c * VEC;
        const bool ok = gk < k_hi && gb < n8;
        const uint8_t* src = ok ? planes + ((size_t)i * K + gk) * n8 + gb : planes;
        copy_async<VEC>(pdst + (i * kBK + r) * kBN8 + c * VEC, src, ok);
      }
    }
    bf16* xdst = xs + slot * MB * kXLd;
    if (x_vec) {
      for (int e = tid; e < MB * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8), c = e % (kBK / 8);
        const int gm = m0 + r, gk = kt + c * 8;
        const bool ok = gm < M && gk < k_hi;
        copy_async<16>(xdst + r * kXLd + c * 8, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
      for (int e = tid; e < MB * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        const int gm = m0 + r, gk = kt + c;
        xdst[r * kXLd + c] =
            (gm < M && gk < k_hi) ? x[(size_t)gm * K + gk] : __ushort_as_bfloat16(0);
      }
    }
    arrive_on_copies(full_x + slot);
  };
  // plain loads (N % 128 != 0, or K % 8 != 0) are not tracked by the
  // barriers: a __syncthreads at each tile makes them visible
  const bool plain_loads = VEC == 1 || !x_vec;

  // rebuild: this thread's K row and 4 plane bytes (32 columns); rows past
  // the split (a box may reach into the next split's rows) are zeros
  const int rk = tid / T::kQuads, rq = tid % T::kQuads;
  const int pad = 16 - bits;
  const bool hi_on = keep > 0 && pad < 8;         // a kept plane lands in a value's high byte
  const bool lo_on = keep > 0 && keep + pad > 8;  // ... in its low byte

  auto rebuild = [&](int t, bf16* w) {
    const uint8_t* src = ps + (t % stages) * stage_planes + rk * kBN8 + rq * 4;
    const bool row_ok = k_lo + t * kBK + rk < k_hi;
    uint32_t hh[4] = {0u, 0u, 0u, 0u}, hl[4] = {0u, 0u, 0u, 0u};
    uint32_t lh[4] = {0u, 0u, 0u, 0u}, ll[4] = {0u, 0u, 0u, 0u};
    if (hi_on && row_ok) rebuild_group(src, kBK * kBN8, 0, pad, keep, hh, hl);
    if (lo_on && row_ok) rebuild_group(src, kBK * kBN8, 8, pad, keep, lh, ll);
    bf16* dst = w + rk * kWLd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 v;
      v.x = prmt(lh[j], hh[j], 0x6273);  // values 0, 1 of byte column j
      v.y = prmt(lh[j], hh[j], 0x4051);  // 2, 3
      v.z = prmt(ll[j], hl[j], 0x6273);  // 4, 5
      v.w = prmt(ll[j], hl[j], 0x4051);  // 6, 7
      *reinterpret_cast<uint4*>(dst + wcol(rq * 32 + j * 8)) = v;
    }
  };

  float acc[MT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8 x 8 matrix, which row
  const int wn = warp * (BN / 8);           // this warp's first column in the tile
  auto multiply = [&](int slot, const bf16* w) {
    const bf16* xt = xs + slot * MB * kXLd;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xt + (mt * 16 + lr + (lm & 1) * 8) * kXLd + ks * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int np = 0; np < T::kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w + (ks * 16 + lr + (lm & 1) * 8) * kWLd +
                                 wcol(wn + np * 16 + (lm >> 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      barrier_init(full_x + s, kThreads);
      barrier_init(full_p + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One __syncthreads a tile: after it every thread has rebuilt tile t into
  // W buffer t & 1 and multiplied tile t - 1, so the stage of tile t - 1
  // takes the loads of tile t + stages - 1 and W buffer (t + 1) & 1 (read
  // by the product of tile t - 1) is free for the next rebuild.
  for (int t = 0; t < stages - 1; ++t) load_tile(t);
  for (int t = 0; t < tiles; ++t) {
    const int slot = t % stages;
    const uint32_t parity = (uint32_t)(t / stages) & 1u;
    if (plain_loads) __syncthreads();
    wait_phase(full_x + slot, parity);
    if (tma) wait_phase(full_p + slot, parity);
    bf16* w = ws + (t & 1) * kBK * kWLd;
    rebuild(t, w);
    __syncthreads();
    load_tile(t + stages - 1);
    multiply(slot, w);
  }

  float* dst = out + (size_t)blockIdx.y * M * N;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
      const int n = blockIdx.x * BN + wn + nt * 8 + 2 * tq;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 16 + g + h * 8;
        if (m < M)
          *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// The decode path (see the header): 8 consumer warps, 1 producer warp, a
// TMA ring of the kept planes' (keep, 32, 64-byte) boxes, each consumer
// warp rebuilding and multiplying its own 64 columns.  Stage slots that no
// kept plane lands in are zeroed once, so the rebuild reads all 8 planes of
// a group with no test.
constexpr int kDecWarps = 8;
constexpr int kDecThreads = (kDecWarps + 1) * 32;
constexpr int kDecBN = 512;
constexpr int kDecBK = 32;
constexpr int kDecWLd = 64 + 8;                 // a warp's W tile row, bf16
constexpr int kDecSlot = kDecBK * kDecBN / 8;   // one plane's box: 2 KB
constexpr int kDecHead = 1024;                  // barriers; ring 1 KB aligned

struct DecodeLayout {
  int g0, slots, zero0, stages, xld;
  size_t ring, x, w, total;
};

// planes at padded positions pad .. pad + keep - 1 (pad = 16 - bits) in
// groups of 8 from group g0: `slots` plane slots a stage, kept plane i at
// slot i + zero0
DecodeLayout decode_layout(int mt, int bits, int keep, int chunk) {
  DecodeLayout d;
  const int pad = 16 - bits;
  d.g0 = pad / 8;
  d.slots = 8 * ((pad + keep - 1) / 8 - d.g0 + 1);
  d.zero0 = pad - 8 * d.g0;
  d.xld = (chunk + 63) / 64 * 64 + 8;
  d.x = (size_t)16 * mt * d.xld * 2;
  d.w = (size_t)kDecWarps * kDecBK * kDecWLd * 2;
  const size_t stage = (size_t)d.slots * kDecSlot;
  long avail = (long)kSmemBudget - kDecHead - (long)d.x - (long)d.w;
  int s = (int)(avail / (long)stage);
  d.stages = s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
  d.ring = (size_t)d.stages * stage;
  d.total = kDecHead + d.ring + d.x + d.w;
  return d;
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// byte b of row r of a 64-byte-row box written with the 64-byte swizzle
// (16-byte chunk index XOR address bits 7-8, i.e. (r >> 1) & 3)
__device__ __forceinline__ int swz64(int r, int b) {
  return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// Ablation builds (-DBPM_ABLATE=n; bitplane_matmul_ablation.py times them;
// their results are wrong by design): 1 leaves out the decode path's
// rebuild (no plane read from shared memory, no transpose, no W store),
// 2 its product (no ldmatrix, no mma), 3 both, so only the plane loads and
// the barriers remain.  0, the default, is the kernel.
#ifndef BPM_ABLATE
#define BPM_ABLATE 0
#endif
constexpr bool kRebuild = BPM_ABLATE == 0 || BPM_ABLATE == 2;
constexpr bool kProduct = BPM_ABLATE == 0 || BPM_ABLATE == 1;

// grid (column tiles, splits, x slabs); with more than one split, `out` is
// the (splits, M, N) workspace.
template <int MT>
__global__ void __launch_bounds__(kDecThreads, MT == 1 ? 2 : 1)
    bitplane_matmul_decode_kernel(const bf16* __restrict__ x,
                                  const __grid_constant__ CUtensorMap map,
                                  float* __restrict__ out, int M, int K, int N, int keep,
                                  int chunk, DecodeLayout d) {
  constexpr int MB = 16 * MT;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kMaxStages], count 1
  uint64_t* empty = full + kMaxStages;                   // [kMaxStages], count kDecWarps
  uint8_t* ring = smem + kDecHead;                       // [stages][slots][kDecSlot]
  bf16* xs = reinterpret_cast<bf16*>(ring + d.ring);     // [MB][xld]
  bf16* wt = reinterpret_cast<bf16*>(ring + d.ring + d.x);  // [warps][kDecBK][kDecWLd]
  const int stage_bytes = d.slots * kDecSlot;

  const int nb0 = blockIdx.x * (kDecBN / 8);
  const int k_lo = blockIdx.y * chunk;
  const int k_hi = min(K, k_lo + chunk);
  const int tiles = k_hi > k_lo ? (k_hi - k_lo + kDecBK - 1) / kDecBK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < d.stages; ++s) {
      barrier_init(full + s, 1);
      barrier_init(empty + s, kDecWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zero the slots no kept plane lands in (TMA never writes them)
  for (int s = 0; s < d.stages; ++s) {
    for (int slot = 0; slot < d.slots; ++slot) {
      if (slot >= d.zero0 && slot < d.zero0 + keep) continue;
      uint4* z = reinterpret_cast<uint4*>(ring + (size_t)s * stage_bytes + slot * kDecSlot);
      for (int e = tid; e < kDecSlot / 16; e += kDecThreads) z[e] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  if (warp == kDecWarps) {  // producer
    if (lane == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int slot = t % d.stages;
        if (t >= d.stages) wait_phase(empty + slot, (uint32_t)(t / d.stages + 1) & 1u);
        tma_planes(ring + (size_t)slot * stage_bytes + d.zero0 * kDecSlot, &map, nb0,
                   k_lo + t * kDecBK, full + slot, keep * kDecSlot);
      }
    }
    return;
  }

  // consumers: the x chunk, once (rows past M or the split are zeros)
  const int xv = d.xld / 8 - 1;  // 16-byte pieces a row that hold the chunk's rows
  for (int e = tid; e < MB * xv; e += kDecWarps * 32) {
    const int r = e / xv, c = e % xv;
    const int gm = blockIdx.z * MB + r, gk = k_lo + c * 8;
    const bool ok = gm < M && gk < k_hi;
    copy_async<16>(xs + r * d.xld + c * 8, ok ? x + (size_t)gm * K + gk : x, ok);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecWarps * 32) : "memory");

  const int r = lane >> 1, q = lane & 1;   // rebuild: rows r, r + 16; plane bytes 8 warp + 4 q ..
  const int rb = swz64(r, 8 * warp + 4 * q);
  bf16* w = wt + warp * kDecBK * kDecWLd;
  const int lm = lane >> 3, lr = lane & 7;
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the value's high byte is group g0's, its low byte group g0 + 1's
  // (zeros when absent); with g0 = 1 (bits <= 8) the group is the low byte
  const bool two = d.slots == 16, low_only = d.g0 == 1;
  for (int t = 0; t < tiles; ++t) {
    const int slot = t % d.stages;
    wait_phase(full + slot, (uint32_t)(t / d.stages) & 1u);
    const uint8_t* src = ring + (size_t)slot * stage_bytes + rb;
    uint32_t g[2][2][2][4];  // [row half][group][hi/lo words][byte column]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        if (!kRebuild || (gi == 1 && !two)) break;
        uint32_t v[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          v[p] = *reinterpret_cast<const uint32_t*>(src + h * 16 * 64 + (gi * 8 + p) * kDecSlot);
        bytes4x4(v[0], v[1], v[2], v[3], g[h][gi][0]);
        bytes4x4(v[4], v[5], v[6], v[7], g[h][gi][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) transpose8(g[h][gi][0][j], g[h][gi][1][j]);
      }
    __syncwarp();
    if (lane == 0) arrive(empty + slot);
#pragma unroll
    for (int h = 0; h < 2 && kRebuild; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t hh = g[h][0][0][j], hl = g[h][0][1][j];
        uint32_t lh = two ? g[h][1][0][j] : 0u, ll = two ? g[h][1][1][j] : 0u;
        if (low_only) {
          lh = hh;
          ll = hl;
          hh = hl = 0u;
        }
        uint4 o;
        o.x = prmt(lh, hh, 0x6273);
        o.y = prmt(lh, hh, 0x4051);
        o.z = prmt(ll, hl, 0x6273);
        o.w = prmt(ll, hl, 0x4051);
        *reinterpret_cast<uint4*>(w + (r + 16 * h) * kDecWLd + (4 * q + j) * 8) = o;
      }
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < kDecBK / 16 && kProduct; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (mt * 16 + lr + (lm & 1) * 8) * d.xld + t * kDecBK + ks * 16 +
                               (lm >> 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w + (ks * 16 + lr + (lm & 1) * 8) * kDecWLd + np * 16 +
                                 (lm >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncwarp();
  }

  float* dst = out + (size_t)blockIdx.y * M * N;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = blockIdx.x * kDecBN + warp * 64 + nt * 8 + 2 * tq;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = blockIdx.z * MB + mt * 16 + gq + h * 8;
        if (m < M)
          *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// out = the splits' partial sums added in split order (n4 float4s each).
__global__ void bitplane_matmul_reduce_kernel(const float4* __restrict__ part,
                                              float4* __restrict__ out, size_t n4, int splits) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = part[p * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
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

// The planes (bits, K, N/8) as a 3-D TMA tensor map with a (box0 bytes,
// box1 rows, keep planes) box; rows past K and bytes past N/8 read as 0.
int encode_planes(CUtensorMap* map, const void* planes, int K, int N, int bits, int box0,
                  int box1, int keep, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N / 8, (cuuint64_t)K, (cuuint64_t)bits};
  const cuuint64_t strides[2] = {(cuuint64_t)N / 8, (cuuint64_t)K * (N / 8)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)keep};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// After a launch into the (splits, M, N) workspace: add the splits into out.
int reduce_splits(const void* work, void* out, int M, int N, int splits, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n4 = (size_t)M * N / 4;
  bitplane_matmul_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float4*>(work), static_cast<float4*>(out), n4, splits);
  return (int)cudaGetLastError();
}

template <typename F>
int allow_smem(F* kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  configured = err == cudaSuccess;
  return (int)err;
}

template <int VEC, int MT>
int launch(const void* x, const void* planes, void* out, void* work, int M, int K, int N,
           int bits, int keep, int splits, int chunk, cudaStream_t stream) {
  using T = Tile;
  static bool configured = false;
  int err = allow_smem(bitplane_matmul_kernel<VEC, MT>, configured);
  if (err) return err;
  CUtensorMap map = {};
  const int tma = VEC == 16 && keep > 0;
  if (tma && (err = encode_planes(&map, planes, K, N, bits, T::kBN8, T::kBK, keep,
                                  CU_TENSOR_MAP_SWIZZLE_NONE)))
    return err;
  const dim3 grid((N + 127) / 128, splits, (M + 16 * MT - 1) / (16 * MT));
  bitplane_matmul_kernel<VEC, MT><<<grid, kThreads, T::smem(MT, keep), stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(planes), map,
      static_cast<float*>(splits > 1 ? work : out), M, K, N, bits, keep, chunk, K % 8 == 0,
      T::stages(MT, keep), tma);
  return reduce_splits(work, out, M, N, splits, stream);
}

template <int MT>
int launch_decode(const void* x, const void* planes, void* out, void* work, int M, int K,
                  int N, int bits, int keep, int splits, int chunk, cudaStream_t stream) {
  static bool configured = false;
  int err = allow_smem(bitplane_matmul_decode_kernel<MT>, configured);
  if (err) return err;
  CUtensorMap map = {};
  if ((err = encode_planes(&map, planes, K, N, bits, kDecBN / 8, kDecBK, keep,
                           CU_TENSOR_MAP_SWIZZLE_64B)))
    return err;
  const DecodeLayout d = decode_layout(MT, bits, keep, chunk);
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 16 * MT - 1) / (16 * MT));
  bitplane_matmul_decode_kernel<MT><<<grid, kDecThreads, d.total, stream>>>(
      static_cast<const bf16*>(x), map, static_cast<float*>(splits > 1 ? work : out), M, K, N,
      keep, chunk, d);
  return reduce_splits(work, out, M, N, splits, stream);
}

template <int VEC>
int launch_mt(int mt, const void* x, const void* planes, void* out, void* work, int M, int K,
              int N, int bits, int keep, int splits, int chunk, cudaStream_t s) {
  switch (mt) {
    case 1: return launch<VEC, 1>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
    case 2: return launch<VEC, 2>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
    case 4: return launch<VEC, 4>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
    case 8: return launch<VEC, 8>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (M, K) bf16, planes (bits, K, N/8) uint8, out (M, N) float32, work
// (splits, M, N) float32 (unused with one split); mt = 1, 2, 4 or 8 slabs
// of 16 rows; bn = 512 takes the decode path (mt <= 2, N % 128 == 0,
// K % 8 == 0, keep > 0; splits of a multiple of 16 rows), bn = 128 the
// general one; splits chunks of `chunk` rows (a multiple of 8) cover K.
// Returns the CUDA error of the launches (0 = launched); x and planes must
// be 16-byte aligned.
int bitplane_matmul_launch(const void* x, const void* planes, void* out, void* work, int M,
                           int K, int N, int bits, int keep, int mt, int bn, int splits,
                           int chunk, void* stream) {
  if (N % 8 != 0 || keep < 0 || keep > bits || bits > 16 || splits < 1 || chunk % 8 != 0 ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n8 = N / 8;
  if (bn == kDecBN) {
    if (mt > 2 || n8 % 16 != 0 || K % 8 != 0 || keep == 0 || chunk % kDecBK != 0)
      return (int)cudaErrorInvalidValue;
    return mt == 1 ? launch_decode<1>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s)
                   : launch_decode<2>(x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
  }
  if (bn != 128) return (int)cudaErrorInvalidValue;
  if (n8 % 16 == 0)
    return launch_mt<16>(mt, x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
  return launch_mt<1>(mt, x, planes, out, work, M, K, N, bits, keep, splits, chunk, s);
}

}  // extern "C"
