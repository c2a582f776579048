// Flash-attention forward (online softmax over key tiles), for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention, _kernel), the
// TPU form of the forward every attention prefill of the reference runs
// (models/attention.py flash_attention).  It computes, for each batch row b,
// query i and query head h (kv head h / (Hp / Hkv), the grouped layout):
//   s_j  = (q_i . k_j) / sqrt(hd)                    float32
//   keep j < kv_valid[b]; if causal, j <= q_pos[b, i]; if window > 0,
//        j > q_pos[b, i] - window; other scores are the finite -1e30
//   out  = sum_j bf16(exp(s_j - m)) v_j / sum_j exp(s_j - m)
// with the running max m, the running sum and the accumulator in float32 and
// p rounded to bf16 before p . v, as the reference does.
//
// Layouts (the reference's, unchanged), contiguous:
//   q (B, Sq, Hp, hd) bf16   k, v (B, Skv, Hkv, hd) bf16   out like q
//   q_pos (B, Sq) int32      kv_valid (B,) int32
// hd is a multiple of 16 up to 128; Sq and Skv are any length (ragged edges
// are masked here, nothing is padded in device memory).
//
// What bounds it on this card: bf16 tensor-core operations.  At Zamba2-7B's
// prefill shape (B 2, L 4096, 32 heads of 112, causal) the causal half of
// the two products is 2 L^2 hd B H = 240.6 GFLOP, 0.243 ms at 989 TFLOP/s,
// against 235 MB of q, k, v and out, 0.070 ms at 3.35 TB/s.
//
// The design (the launch plan is kernel.py: plan(b, sq, skv, hp, hkv, hd,
// valid), from the shapes and a bound on kv_valid that the caller knows on
// the host; q_pos and kv_valid stay on the device):
// - Blocks: one per (query tile, kv head, batch row, key split).  A
//   block's 128 rows are (token, query head) pairs: 128 / rep tokens times
//   the rep query heads of one kv head, so each K and V tile is read once
//   for all of them (rep = Hp / Hkv; at rep 1 the rows are 128 tokens of
//   one head).  Blocks are issued in groups of (kv head, batch row, split)
//   units whose K and V fit in half of L2, heaviest query tiles first
//   across a group, so that a causal launch ends on light blocks.
// - Warp roles: two consumer warpgroups of 64 rows each, and a producer
//   warpgroup whose first warp issues every load (the other three leave at
//   once); setmaxnreg hands the producer's registers to the consumers
//   (24 / 240 a thread).
// - Loads: TMA tensor copies, completing on mbarriers.  The q tile once,
//   one 4-D box (64 columns, rep heads, tokens, 1) per 64-column slab; K
//   and V tiles of 128 keys into a ring of 3 or 4 stages (as many as fit in
//   shared memory), with full and empty barriers for K and for V apart, so
//   that a K stage is refilled as soon as its q . k^T is done.  The q tile
//   and, without a window, the first key tile are issued before q_pos is
//   read.  Every tile lands in the
//   128-byte swizzled layout that wgmma reads.  A box past Sq, Skv or hd is
//   zero-filled by the TMA unit; the batch row is a dimension of the map,
//   so no box reaches into the next row.  hd 112 (Zamba2) takes two slabs,
//   the second zero past column 112: that costs shared memory and copy
//   bandwidth for 16 columns, no products (q . k walks hd in steps of 16,
//   p . v has N = hd).
// - Products: wgmma.mma_async, bf16 in, float32 accumulate.  s = q . k^T
//   reads both tiles from shared memory through descriptors (K-major);
//   o += p . v takes p from registers (the s accumulator, rounded to bf16,
//   is already the A fragment) and v from shared memory as an MN-major
//   operand, so nothing is transposed.
// - Overlap: each warpgroup issues tile i's q . k^T together with tile
//   i - 1's p . v, and runs tile i's softmax while that p . v runs (p of
//   two tiles stays in registers, one read by p . v while the next is
//   packed; at 128 dims there is room for one only, and the packing waits
//   for p . v).  The two warpgroups' products and softmaxes interleave on
//   their own: explicit turns between them (ping-pong through named
//   barriers) measured no faster and are not used.
// - Masks: key tiles that every row of the block masks (past kv_valid,
//   above the causal diagonal, before the window) are skipped, so a causal
//   launch does the causal half of the work.  Tiles that no row masks take
//   no per-element test; only tiles at the diagonal, the window edge or
//   the kv_valid edge do.  exp is exp2 with log2(e) folded into the scale.
// - A row whose first visited tile holds no key it may see keeps m = -1e30;
//   the next visible key's correction exp(-1e30 - m) = 0 wipes what it
//   gathered.  A row that sees no key in any visited tile returns 0.
// - Split over keys: where the query tiles alone leave the card at least
//   half idle and a block would walk 4 key tiles or more (a prefill chunk
//   at an offset into its slot), the key tiles below the caller's bound on
//   kv_valid are cut into ranges, one a block, the last running on to the
//   end of the keys; each block writes float32 partials (acc, m, l) to a
//   workspace the wrapper allocates, and a second kernel of the same call
//   merges them, one warp a row, splits in a fixed order (a call repeats
//   bit for bit).  A split with no visible tile writes only l = 0.  The
//   merge costs about one tile's walk, so at 2 or 3 tiles (a short first
//   chunk of a prompt) a block walks them itself.
//
// Measured (chip_smoke.py phase 6 on an H100; numbers in PERF.md section
// 6): at Zamba2-7B's shape the kernel runs at about half its operation
// bound, level with PyTorch's SDPA.  At 128 dims ptxas runs out of
// registers for the products' overlap (it reports the wgmma serialized,
// and spills a little).

#include <algorithm>
#include <climits>
#include <cmath>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;       // query rows a block: 64 a consumer warpgroup
constexpr int kKeys = 128;       // keys a tile
constexpr int kSlab = 64;        // columns of one 128-byte swizzled slab
constexpr int kRowBytes = 128;   // bytes of one slab row
constexpr int kThreads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024;
constexpr int kAlign = 1024;     // the 128-byte swizzle repeats every 8 rows
constexpr int kBarrierBytes = 256;
constexpr int kMergeWarps = 8;
constexpr long long kGroupBytes = 24ll << 20;  // K and V of a group of units: half of L2
constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;
static_assert((1 + 4 * kMaxStages) * 8 + 4 <= kBarrierBytes, "the mbarriers and a word fit");

struct Params {
  CUtensorMap q_map, k_map, v_map;  // 4-D: (hd, heads, tokens, B)
  const int* q_pos;
  const int* kv_valid;
  bf16* out;
  float* ws;  // splits > 1: acc (splits, rows, hd), then (m, l) pairs (splits, rows)
  int B, Sq, Skv, Hp, Hkv, rep;
  int tokens;  // tokens a block: kRows / rep
  int splits, tiles_per_split, stages;
  int qtiles;  // blocks along Sq
  int group;  // (kv head, batch row, split) units whose blocks are issued together
  int causal, window;
  float scale2;  // log2(e) / sqrt(hd): scores in log2 units
};

// Shared memory, from a kAlign-aligned base: the q tile (one slab of kRows
// rows per 64 columns), then each ring stage's K and V tiles (one slab of
// kKeys rows per 64 columns each), then the mbarriers: q | K full | V full
// | K empty | V empty, each x stages.
template <int HD>
struct Smem {
  static constexpr int kSlabs = (HD + kSlab - 1) / kSlab;
  static constexpr int kQ = kSlabs * kRows * kRowBytes;
  static constexpr int kTile = kSlabs * kKeys * kRowBytes;
  static constexpr int kStage = 2 * kTile;
  static constexpr int bytes(int stages) { return kAlign + kQ + stages * kStage + kBarrierBytes; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Expect `bytes` more on bar, and arrive (a barrier of count 1).
__device__ __forceinline__ void arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One TMA copy through the 4-D `map` of the box at (c0, c1, c2, c3) into
// dst, completing its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N groups of this warp's wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the (volatile) wgmma issue and wait statements.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


// wgmma matrix descriptor of a tile in the 128-byte swizzled layout at
// shared address `addr`: `lbo` bytes between 64-element slabs along M or N
// (MN-major operands), `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// s (64 x 128) = q . k^T (accumulate = 0) or += it; q and k K-major bf16
// tiles in shared memory, read through descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// o (64 x N) += p . v; p in registers (per warp, the A layout of
// mma.m16n8k16), v an MN-major bf16 tile in shared memory.  One
// specialisation a head dim, N = HD: the accumulator d is N / 2 registers
// (%0 ...), then come p's four registers, v's descriptor and the operand
// that sets the accumulate predicate; REGS lists the accumulator operands
// and TAIL numbers the rest.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

#define WGMMA_RS(N, REGS, TAIL, PRED, ...)                                                   \
  template <>                                                                                \
  __device__ __forceinline__ void wgmma_rs<N>(float (&d)[N / 2], const uint32_t (&a)[4],     \
                                              uint64_t b) {                                  \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " PRED ", 0;\n"                        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " TAIL \
                 ", p, 1, 1, 1;\n}\n"                                                        \
                 : __VA_ARGS__                                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));              \
  }
#define D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R16 R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define R24 R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define R32 R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define R40 R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define R48 R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define R56 R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define R64 R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
WGMMA_RS(16, R8, "{%8, %9, %10, %11}, %12", "%13", D8(0))
WGMMA_RS(32, R16, "{%16, %17, %18, %19}, %20", "%21", D8(0), D8(8))
WGMMA_RS(48, R24, "{%24, %25, %26, %27}, %28", "%29", D8(0), D8(8), D8(16))
WGMMA_RS(64, R32, "{%32, %33, %34, %35}, %36", "%37", D8(0), D8(8), D8(16), D8(24))
WGMMA_RS(80, R40, "{%40, %41, %42, %43}, %44", "%45", D8(0), D8(8), D8(16), D8(24), D8(32))
WGMMA_RS(96, R48, "{%48, %49, %50, %51}, %52", "%53", D8(0), D8(8), D8(16), D8(24), D8(32),
         D8(40))
WGMMA_RS(112, R56, "{%56, %57, %58, %59}, %60", "%61", D8(0), D8(8), D8(16), D8(24), D8(32),
         D8(40), D8(48))
WGMMA_RS(128, R64, "{%64, %65, %66, %67}, %68", "%69", D8(0), D8(8), D8(16), D8(24), D8(32),
         D8(40), D8(48), D8(56))
#undef WGMMA_RS
#undef D8
#undef R8
#undef R16
#undef R24
#undef R32
#undef R40
#undef R48
#undef R56
#undef R64

// The key tiles [begin, end) of a block's split that some row of the block
// may see, and the block's query position range; every warp that needs
// them computes them alike (its lanes stride over the block's tokens).
struct Range {
  int begin, end, qmin, qmax, kv_end;
};

__device__ __forceinline__ Range key_range(const Params& p, int b, int t0, int ntok, int split) {
  const int lane = threadIdx.x % 32;
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = lane; i < ntok; i += 32) {
    const int v = p.q_pos[(size_t)b * p.Sq + t0 + i];
    qmin = min(qmin, v);
    qmax = max(qmax, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  Range r;
  r.qmin = __shfl_sync(0xffffffffu, qmin, 0);  // a broadcast: uniform to the compiler
  r.qmax = __shfl_sync(0xffffffffu, qmax, 0);
  r.kv_end = max(0, min(p.kv_valid[b], p.Skv));
  int hi = r.kv_end;
  if (p.causal && qmax < hi) hi = qmax + 1;
  const int lo = p.window > 0 ? max(0, qmin - p.window + 1) : 0;
  // the last split runs on to the end of the keys (the plan may cover only
  // the tiles below a bound on kv_valid that the caller gave it)
  const int cap = split + 1 < p.splits ? (split + 1) * p.tiles_per_split : INT_MAX;
  r.begin = max(lo / kKeys, split * p.tiles_per_split);
  r.end = hi > lo ? min((hi + kKeys - 1) / kKeys, cap) : 0;
  r.end = max(r.begin, r.end);
  r.kv_end = __shfl_sync(0xffffffffu, r.kv_end, 0);
  r.begin = __shfl_sync(0xffffffffu, r.begin, 0);
  r.end = __shfl_sync(0xffffffffu, r.end, 0);
  return r;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ Params p) {
  using L = Smem<HD>;
  constexpr int kSlabs = L::kSlabs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t q_tile = base, ring = base + L::kQ;
  const uint32_t bars = ring + p.stages * L::kStage;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return ring + s * L::kStage; };
  auto v_tile = [&](int s) { return ring + s * L::kStage + L::kTile; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kMaxStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kMaxStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kMaxStages + s); };

  // Block order: units (kv head, batch row, split) in groups of p.group,
  // whose K and V fit in L2 together; inside a group the query tiles go
  // heaviest first across its units, so that a launch ends on light blocks.
  const int units = p.Hkv * p.B * p.splits;
  const int grp = blockIdx.x / (p.group * p.qtiles);
  const int gn = min(p.group, units - grp * p.group);
  const int at = blockIdx.x - grp * p.group * p.qtiles;
  const int qt = p.qtiles - 1 - at / gn;
  const int unit = grp * p.group + at % gn;
  const int g = unit % p.Hkv;  // kv head
  const int split = unit / p.Hkv % p.splits, b = unit / p.Hkv / p.splits;
  const int t0 = qt * p.tokens;
  const int ntok = min(p.tokens, p.Sq - t0);
  const int rows = ntok * p.rep;  // real rows; row r is token t0 + r / rep, head g rep + r % rep
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    barrier_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      barrier_init(k_full(s), 1);
      barrier_init(v_full(s), 1);
      barrier_init(k_empty(s), kConsumers / 32);  // each consumer warp's lane 0
      barrier_init(v_empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: its first warp's lane 0 issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32) return;
    auto load_q = [&]() {
      arrive_expect_tx(q_full, kSlabs * p.rep * p.tokens * kRowBytes);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(q_tile + c * kRows * kRowBytes, &p.q_map, c * kSlab, g * p.rep, t0, b, q_full);
    };
    // ring slot i: key tile `tile`'s K and V, each once its stage is free
    auto load_kv = [&](int i, int tile) {
      const int s = i % p.stages;
      const uint32_t ready = ((i / p.stages) & 1) ^ 1;  // the first round passes at once
      const int key0 = tile * kKeys;
      wait_phase(k_empty(s), ready);
      arrive_expect_tx(k_full(s), L::kTile);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(k_tile(s) + c * kKeys * kRowBytes, &p.k_map, c * kSlab, g, key0, b, k_full(s));
      wait_phase(v_empty(s), ready);
      arrive_expect_tx(v_full(s), L::kTile);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(v_tile(s) + c * kKeys * kRowBytes, &p.v_map, c * kSlab, g, key0, b, v_full(s));
    };
    // The q tile and, without a window, the split's first key tile do not
    // depend on q_pos: they are issued before the key range is known, so
    // that the q_pos loads are off the first tile's path.
    const int first = split * p.tiles_per_split;
    const bool early = p.window <= 0;
    if (lane == 0) {
      load_q();
      if (early) load_kv(0, first);
    }
    const Range r = key_range(p, b, t0, ntok, split);
    const int n = r.end - r.begin;  // with `early` and n > 0, r.begin == first
    if (lane != 0) return;
    if (n == 0) {  // nothing to compute: the copies land before the block ends
      wait_phase(q_full, 0);
      if (early) {
        wait_phase(k_full(0), 0);
        wait_phase(v_full(0), 0);
      }
      return;
    }
    for (int i = early ? 1 : 0; i < n; ++i) load_kv(i, r.begin + i);
    return;
  }

  // Consumer warpgroups: warpgroup wg owns rows [64 wg, 64 wg + 64); this
  // thread holds rows row0 and row0 + 8 (the m16n8k16 accumulator layout).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  constexpr int kK = HD / 16;    // k-steps of q . k^T
  constexpr int kP = kKeys / 16;  // k-steps of p . v
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = wg * 64 + (warp % 4) * 16 + gq;
  const Range r = key_range(p, b, t0, ntok, split);
  const int n = r.end - r.begin;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    qp[i] = row < rows ? p.q_pos[(size_t)b * p.Sq + t0 + row / p.rep] : r.qmin;
  }
  const float scale2 = p.scale2;

  float o[HD / 2], s[kKeys / 2];
  // p of two tiles, one read by p . v while the next is packed; at 128 dims
  // the registers hold one (ptxas would serialize the products), and the
  // packing waits for p . v
  constexpr int kPBufs = HD <= 112 ? 2 : 1;
  uint32_t pa[kPBufs][kP][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};

  // descriptors: q (K-major, this warpgroup's 64 rows), k (K-major), v
  // (MN-major: 64-column slabs kKeys rows apart)
  const uint64_t q_desc = descriptor(q_tile + wg * 64 * kRowBytes, 16, 8 * kRowBytes);
  auto qk_step = [](int kk) {
    return (uint64_t)(((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4);
  };
  auto kk_step = [](int kk) {
    return (uint64_t)(((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4);
  };

  // Online softmax of tile i's scores, in log2 units: the running max and
  // sum, `corr` for what was gathered before, p in s.
  auto softmax = [&](int i) {
    const int k0 = (r.begin + i) * kKeys;
    const bool whole = k0 + kKeys <= r.kv_end && (!p.causal || k0 + kKeys - 1 <= r.qmin) &&
                       (p.window <= 0 || k0 > r.qmax - p.window);
    // A whole tile keeps raw scores, and the scale is folded into exp2's
    // argument; a masked tile is scaled here, its masked scores set to the
    // finite -1e30 (as in the plain version: a row that has seen only
    // masked keys then takes p = 1, which the first visible key's
    // correction wipes).
    float mx[2] = {kNegInf, kNegInf};
    if (!whole) {  // row i2 sees keys [lo, hi), here as columns of the thread's tile
      int lo[2], hi[2];
      const int c0 = k0 + 2 * tq;
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        hi[i2] = (p.causal ? min(r.kv_end, qp[i2] + 1) : r.kv_end) - c0;
        lo[i2] = qp[i2] - p.window + 1 - c0;
      }
      if (p.window > 0) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          const int col = (e >> 2) * 8 + (e & 1);  // a constant once unrolled
          const bool out = col < lo[(e >> 1) & 1] || col >= hi[(e >> 1) & 1];
          s[e] = out ? kNegInf : s[e] * scale2;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          s[e] = (e >> 2) * 8 + (e & 1) >= hi[(e >> 1) & 1] ? kNegInf : s[e] * scale2;
      }
    }
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    const float sc = whole ? scale2 : 1.f;
    mx[0] *= sc;
    mx[1] *= sc;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      mx[i2] = fmaxf(mx[i2], m[i2]);
      corr[i2] = ex2(m[i2] - mx[i2]);
      m[i2] = mx[i2];
      l[i2] *= corr[i2];
    }
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      s[e] = ex2(fmaf(s[e], sc, -m[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
  };
  // p, rounded to bf16, as the A fragments of p . v
  auto pack_p = [&](uint32_t (&frag)[kP][4]) {
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) frag[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
  };
  auto issue_qk = [&](int st) {
    const uint64_t k_desc = descriptor(k_tile(st), 16, 8 * kRowBytes);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      wgmma_ss_n128(s, q_desc + qk_step(kk), k_desc + kk_step(kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int st, uint32_t (&frag)[kP][4]) {
    const uint64_t v_desc = descriptor(v_tile(st), kKeys * kRowBytes, 8 * kRowBytes);
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
      wgmma_rs<HD>(o, frag[kk], v_desc + (uint64_t)((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
  };
  auto phase = [&](int i) { return (uint32_t)((i / p.stages) & 1); };
  const uint32_t pin = bars + kBarrierBytes - 4;  // a word no one reads

  // Tile i (0 < i < n): q . k^T of tile i; the wait for p . v of tile i - 2
  // (after this issue, so that the compiler does not hoist it above the
  // softmax of tile i - 1); o rescaled by tile i - 1's correction, and p . v
  // of tile i - 1 from `prev_p`.  Then the softmax of tile i into `next_p`
  // while that p . v runs (and the other warpgroup's products).
  auto tile = [&](int i, uint32_t (&prev_p)[kP][4], uint32_t (&next_p)[kP][4]) {
    const int st = i % p.stages, prev = (i - 1) % p.stages;
    wait_phase(k_full(st), phase(i));
    wait_phase(v_full(prev), phase(i - 1));
    fence_regs(s);
    wgmma_fence();
    issue_qk(st);
    wgmma_wait<1>();  // p . v of tile i - 2 is done
    fence_regs(o);
    if (i >= 2 && lane == 0) arrive(v_empty((i - 2) % p.stages));
    rescale_o();
    fence_regs(o);
    wgmma_fence();
    issue_pv(prev, prev_p);
    wgmma_wait<1>();  // q . k^T of tile i is done; p . v may still run
    fence_regs(s);
    if (lane == 0) arrive(k_empty(st));
    softmax(i);
    if constexpr (kPBufs == 1) {
      wgmma_wait<0>();
      fence_regs(o);
    }
    pack_p(next_p);
    // A shared-memory store of the row sums, which need every exp2 of the
    // tile: the compiler keeps it above the next tile's barrier waits, so
    // the softmax stays here, beside p . v.
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(pin), "f"(l[0] + l[1]) : "memory");
  };
  // the last tile's p . v, after the wait for the one before it
  auto finish = [&](uint32_t (&last_p)[kP][4]) {
    const int last = (n - 1) % p.stages;
    wait_phase(v_full(last), phase(n - 1));
    wgmma_wait<0>();
    fence_regs(o);
    if (n >= 2 && lane == 0) arrive(v_empty((n - 2) % p.stages));
    rescale_o();
    fence_regs(o);
    wgmma_fence();
    issue_pv(last, last_p);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) arrive(v_empty(last));
  };

  // No wgmma sits under a condition the compiler cannot see is uniform
  // across the warpgroup, which would serialize them.
  if (n > 0) {
    wait_phase(q_full, 0);
    wait_phase(k_full(0), 0);
    fence_regs(s);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) arrive(k_empty(0));
    softmax(0);
    pack_p(pa[0]);
    int i = 1;
    constexpr int j = kPBufs - 1;
    for (; i + 1 < n; i += 2) {  // two tiles a pass: the p fragments swap roles
      tile(i, pa[0], pa[j]);
      tile(i + 1, pa[j], pa[0]);
    }
    if (i < n) {
      tile(i, pa[0], pa[j]);
      finish(pa[j]);
    } else {
      finish(pa[0]);
    }
  }


  // epilogue: this thread's two rows
  const size_t rows_all = (size_t)p.B * p.Sq * p.Hp;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
    const int row = row0 + 8 * i2;
    if (row >= rows) continue;
    const size_t grow = ((size_t)b * p.Sq + t0 + row / p.rep) * p.Hp + g * p.rep + row % p.rep;
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(l[i2], 1e-30f);
      bf16* dst = p.out + grow * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * i2] * inv, o[4 * j + 2 * i2 + 1] * inv);
    } else {
      const size_t prow = (size_t)split * rows_all + grow;
      if (tq == 0)
        reinterpret_cast<float2*>(p.ws + (size_t)p.splits * rows_all * HD)[prow] =
            make_float2(m[i2], l[i2]);
      if (n == 0) continue;
      float* dst = p.ws + prow * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * i2], o[4 * j + 2 * i2 + 1]);
    }
  }
}

// Merges the splits' partials of each row: one warp a row, 4 columns a lane,
// splits in order; a split with l = 0 saw no tile and is left out, and a
// row no split saw is 0.
template <int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
    flash_attention_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                                 int rows_all, int splits) {
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int c = 4 * (threadIdx.x % 32);
  if (row >= rows_all || c >= HD) return;
  const float2* ml = reinterpret_cast<const float2*>(ws + (size_t)splits * rows_all * HD);
  float mmax = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const float2 t = ml[(size_t)s * rows_all + row];
    if (t.y > 0.f) mmax = fmaxf(mmax, t.x);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float lsum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 t = ml[(size_t)s * rows_all + row];
    if (t.y <= 0.f) continue;
    const float w = ex2(t.x - mmax);
    const float4 a = *reinterpret_cast<const float4*>(ws + ((size_t)s * rows_all + row) * HD + c);
    lsum += w * t.y;
    acc.x += w * a.x;
    acc.y += w * a.y;
    acc.z += w * a.z;
    acc.w += w * a.w;
  }
  const float den = fmaxf(lsum, 1e-30f);
  uint2 v;
  v.x = pack_bf16(acc.x / den, acc.y / den);
  v.y = pack_bf16(acc.z / den, acc.w / den);
  *reinterpret_cast<uint2*>(out + (size_t)row * HD + c) = v;
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

// A 4-D map of a contiguous (B, len, heads, hd) bf16 tensor, boxes of 64
// columns x box_heads x box_len x 1 in the 128-byte swizzle; what lies
// outside the tensor reads as zeros.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd, int heads,
                int len, int B, int box_heads, int box_len) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, (cuuint32_t)box_heads, (cuuint32_t)box_len, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* kv_valid,
           void* out, void* ws, int B, int Sq, int Skv, int Hp, int Hkv, int causal, int window,
           int tokens, int splits, int tiles_per_split, cudaStream_t stream) {
  using L = Smem<HD>;
  const int rep = Hp / Hkv;
  if (tokens < 1 || tokens * rep > kRows || splits < 1 || tiles_per_split < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Params p{};
  if (!encode_map(encode, &p.q_map, q, HD, Hp, Sq, B, rep, tokens) ||
      !encode_map(encode, &p.k_map, k, HD, Hkv, Skv, B, 1, kKeys) ||
      !encode_map(encode, &p.v_map, v, HD, Hkv, Skv, B, 1, kKeys))
    return (int)cudaErrorInvalidValue;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hp = Hp;
  p.Hkv = Hkv;
  p.rep = rep;
  p.tokens = tokens;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.stages = std::min(kMaxStages, (kSmemMax - L::bytes(0)) / L::kStage);
  p.causal = causal;
  p.window = window;
  p.scale2 = (float)(kLog2e / std::sqrt((double)HD));
  const int smem = L::bytes(p.stages);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  p.qtiles = (Sq + tokens - 1) / tokens;
  const int units = Hkv * B * splits;
  const long long unit_bytes = 4ll * Skv * HD;  // K and V of one kv head of one batch row
  p.group = (int)std::max(1ll, std::min((long long)units, kGroupBytes / unit_bytes));
  flash_attention_kernel<HD><<<p.qtiles * units, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int rows_all = B * Sq * Hp;
  flash_attention_merge_kernel<HD><<<(rows_all + kMergeWarps - 1) / kMergeWarps,
                                     kMergeWarps * 32, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(out), rows_all, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launches (0 = launched); cudaErrorInvalidValue
// for a head_dim the kernel is not built for (a multiple of 16 up to 128) or
// a plan it cannot take (kernel.py: plan gives tokens, splits and key tiles a
// split; ws holds the splits' partials when splits > 1).
int flash_attention_launch(const void* q, const void* k, const void* v, const void* q_pos,
                           const void* kv_valid, void* out, void* ws, int B, int Sq, int Skv,
                           int Hp, int Hkv, int hd, int causal, int window, int tokens,
                           int splits, int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(HD)                                                                      \
  case HD:                                                                                  \
    return launch<HD>(q, k, v, q_pos, kv_valid, out, ws, B, Sq, Skv, Hp, Hkv, causal, window, \
                      tokens, splits, tiles_per_split, s);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // extern "C"
