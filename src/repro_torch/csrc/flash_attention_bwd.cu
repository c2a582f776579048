// Flash-attention backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's TPU kernel
// (src/repro/kernels/flash_attention/kernel.py) is forward only, and the
// reference differentiates attention through the custom VJP of its jnp flash
// attention, src/repro/models/attention.py _flash_bwd ("the production
// flash-kernel contract").  This kernel computes that backward, with its
// rounding points: for each batch row b, query i and query head h (kv head
// g = h / rep, rep = Hp / Hkv, the grouped layout) and key j,
//   s_ij  = (q_i . k_j) / sqrt(hd)                 float32 (bf16 operands)
//   p_ij  = exp(s_ij - lse_i) where key j is visible to query i, else 0
//   delta_i = sum_d dout_id out_id                   float32
//   dv_j += bf16(p_ij) dout_i                       summed over i and the rep heads
//   dp_ij = dout_i . v_j                             float32
//   ds_ij = p_ij (dp_ij - delta_i) / sqrt(hd)        float32
//   dq_i += bf16(ds_ij) k_j,  dk_j += bf16(ds_ij) q_i (summed over the rep heads)
// with every sum in float32 and dq, dk, dv rounded to bf16 at the end.  Key
// j is visible to query i when j < kv_valid[b], and, if causal, j <= q_pos[b,
// i], and, with a window, j > q_pos[b, i] - window: the forward's masks at
// key indices (the reference's backward rebuilds key positions from indices
// and takes no kv_pos; the wrapper refuses a backward through kv_pos).  lse
// is the forward's log-sum-exp (flash_attention.cu writes it on request).
//
// Layouts (the reference's), contiguous:
//   q, out, dout, dq (B, Sq, Hp, hd) bf16   k, v, dk, dv (B, Skv, Hkv, hd) bf16
//   lse (B, Hp, Sq) float32   q_pos (B, Sq) int32   kv_valid (B,) int32
// hd is a multiple of 16 up to 128.
//
// What bounds it on this card: bf16 tensor-core operations, five products
// of 2 hd flops over every visible (query, key) pair (s, dp, dv, dq, dk),
// against q, k, v, out, dout, lse read once and dq, dk, dv written once.
// At SmolLM-135M's training shape (B 8, L 2,048, 9 heads of 64, causal)
// that is 5 x 2 x 64 x 9 x 8 x 2,098,176 = 96.7 GFLOP, 0.098 ms at 989
// TFLOP/s, against 101 MB, 0.030 ms at 3.35 TB/s.  So the design keeps the
// tensor cores fed: wgmma for every product, operands landing by TMA while
// the last tile is multiplied, and five products a visible pair, not seven.
//
// The design (the launch's row tiles and workspace are Layout below, whose
// size the wrapper asks of flash_attention_bwd_workspace; one C call
// launches three kernels and counts one launch):
// - Rows: the (query, head) rows of one kv head are walked in row tiles of
//   kRows = 64 slots, `tokens` = 64 / rep consecutive queries times the rep
//   query heads (slot (t - t0) rep + h % rep), so that a q or dout tile is
//   one TMA box of the (B, Sq, Hp, hd) tensor, and the sum over the rep
//   heads is part of every product's own reduction (dk and dv need no
//   atomics).  Slots past tokens x rep stay empty (rep 3: 63 of 64 used).
// - Pre-pass (flash_attention_bwd_prep_kernel, one block a row tile and kv
//   head, four threads a slot): delta of each slot's row (dout . out,
//   float32), its lse in log2 units and its query position, written as one
//   768-byte record a tile (an empty slot or one past Sq gets lse = +inf,
//   so p = 0 there), each tile's (min, max) query position, and the tile's
//   rows of the dq workspace zeroed.
// - Main kernel (flash_attention_bwd_kernel): one block per (128-key tile,
//   kv head, batch row), issued key tiles outermost, so that under a causal
//   mask the blocks that see the most rows (the first key tiles) start
//   first and a launch ends on light blocks.  K and V of the block are
//   loaded once; a producer warp streams the row tiles that some slot of
//   the block may see (the tile's position range against the block's keys:
//   past the causal diagonal, before the window, past kv_valid a tile is
//   skipped) through a ring of 2 to 4 stages of q, dout and the tile's
//   record, full and empty mbarriers per stage, every tile in the 128-byte
//   swizzled layout wgmma reads.  setmaxnreg gives the producer's
//   registers to the consumers (24 / 240 a thread), as in the forward.
// - Two consumer warpgroups, 64 keys each.  Per row tile, five wgmma
//   products: s^T = K q^T and dp^T = V dout^T (64 keys x 64 slots, both
//   operands from shared memory); p^T and ds^T formed in registers (exp2
//   with log2(e) folded into the scale, the mask tested per element only
//   on tiles that some pair of the block masks); dv += bf16(p^T) dout and
//   dk += bf16(ds^T) q with A from registers (the accumulators, rounded to
//   bf16, are already the A fragments) and B MN-major, so nothing is
//   transposed; ds^T stored to shared memory (two buffers, one a tile in
//   turn), then dq (64 slots x its columns) += bf16(ds) K over the block's
//   128 keys, A read from the ds^T buffer MN-major and B from the K tile
//   MN-major.  Up to 64 dims one warpgroup takes a tile's whole dq, the two
//   in turn, and named barriers (ds^T written, ds^T read) replace a
//   lockstep, so one warpgroup's exp and stores run beside the other's
//   products; above 64 dims each takes 64 columns of every tile.
// - dq is summed across key tiles in a float32 workspace laid out by row
//   tile (B, Hkv, column chunks, Sq rep, 64 or hd columns): the tile's dq
//   is staged in shared memory (up to 64 dims in the ds^T buffer its
//   product has just read) and added by one bulk reduction of the copy
//   engine (cp.reduce.async.bulk .add.f32), contiguous rows on both sides;
//   a last small kernel (flash_attention_bwd_dq_kernel) rounds the sums to
//   bf16 in dq's layout.  The float32 sums run in an order that changes
//   from run to run, so dq may differ by one bf16 rounding between two
//   runs; dk and dv are summed in a fixed order and repeat bit for bit.
// - dk and dv leave from the accumulators, rounded to bf16, once a block.
//
// What measured slower on the card (PERF.md, PR 27): the next tile's s^T
// and dp^T issued before the last tile's dq leaves (ptxas serializes wgmma
// whose accumulators live across the loop), 128-slot row tiles and three
// consumer warpgroups (both spill), dq summed by float4 atomics or by one
// bulk reduction a row.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kKeys = 128;       // keys a block: 64 a consumer warpgroup
constexpr int kRows = 64;        // row slots of a row tile
constexpr int kSlab = 64;        // columns of one 128-byte swizzled slab
constexpr int kRowBytes = 128;   // bytes of one slab row
constexpr int kThreads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024;
constexpr int kAlign = 1024;     // the 128-byte swizzle repeats every 8 rows
constexpr int kBarrierBytes = 128;
constexpr int kPrepThreads = 256;
constexpr int kDqThreads = 256;
constexpr double kLog2e = 1.4426950408889634;
static_assert((1 + 2 * kMaxStages) * 8 <= kBarrierBytes, "the mbarriers fit");

// dq's columns a product: all of them up to 64 dims, else 64 (a slab of K)
__host__ __device__ constexpr int dq_cols(int hd) { return hd <= kSlab ? hd : kSlab; }

// A launch's row tiles and its float32 workspace, from the shapes alone:
// dq's sums (B, Hkv, chunks, Sq rep, dq_cols(hd)), then each row tile's
// record (3 kRows floats), then each tile's (min, max) query position.
struct Layout {
  int rep, tokens, tiles;  // tokens: queries a row tile (kRows / rep)
  size_t dq_floats, info_floats, range_floats;
  size_t floats() const { return dq_floats + info_floats + range_floats; }
};

// false for shapes the kernels do not take: hd not a multiple of 16 up to
// 128, heads that do not group, more than kRows q heads a kv head
bool layout(int B, int Sq, int Hp, int Hkv, int hd, Layout* l) {
  if (B <= 0 || Sq <= 0 || Hp <= 0 || Hkv <= 0 || Hp % Hkv != 0 || hd < 16 || hd > 128 ||
      hd % 16 != 0 || Hp / Hkv > kRows)
    return false;
  l->rep = Hp / Hkv;
  l->tokens = kRows / l->rep;
  l->tiles = (Sq + l->tokens - 1) / l->tokens;
  const int nq = dq_cols(hd);
  l->dq_floats = (size_t)B * Sq * Hp * ((hd + nq - 1) / nq) * nq;
  l->info_floats = (size_t)B * Hkv * l->tiles * 3 * kRows;
  l->range_floats = (size_t)B * Hkv * l->tiles * 2;  // an int2 a tile
  return true;
}

// Where column c (a multiple of 2) of a tile's row `slot` lies in the dq
// workspace's row of nq columns: its pair of columns rotated by 4 (slot %
// 4) pairs, so that a warp's stores of the staged rows fall in distinct
// shared-memory banks (a row of 64 float32 spans every bank once).
__host__ __device__ constexpr int dq_col_at(int c, int slot, int nq) {
  return (c + 8 * (slot % 4)) % nq;
}

struct Params {
  CUtensorMap q_map, do_map, k_map, v_map;  // 4-D: (hd, heads, tokens, B)
  const float* info;  // (B, Hkv, tiles, 3 kRows): each tile's record
  const int2* range;  // (B, Hkv, tiles): the tile's (min, max) query position
  const int* kv_valid;
  // dq's float32 sums, zeroed by the pre-pass: (B, Hkv, chunks, Sq rep,
  // dq_cols(hd)), row t rep + h % rep of kv head h / rep, chunk c holding
  // columns [c dq_cols, (c + 1) dq_cols) (rotated: dq_col_at); a row
  // tile's rows are contiguous
  float* dq_ws;
  bf16 *dk, *dv;
  int B, Sq, Skv, Hp, Hkv, rep, tokens, tiles, stages, causal, window;
  float scale;   // 1 / sqrt(hd)
  float scale2;  // log2(e) / sqrt(hd): scores in log2 units
};

struct PrepParams {
  const bf16 *out, *dout;
  const float* lse;
  const int* q_pos;
  float* info;
  int2* range;
  float* dq_ws;
  int Sq, Hp, Hkv, rep, tokens, tiles, hd;
};

// The block's shared memory, from a kAlign-aligned base: the K tile and the
// V tile (one slab of kKeys rows per 64 columns each), two ds^T buffers
// (kKeys rows of kRows slots), above 64 dims each warpgroup's dq staging,
// then each ring stage's q and dout tiles (one slab of kRows rows per 64
// columns each) and its record (lse in log2 units, delta, the query
// position: 3 kRows words), then the mbarriers: K/V full | full x stages
// | empty x stages.
template <int HD>
struct Smem {
  static constexpr int kSlabs = (HD + kSlab - 1) / kSlab;
  static constexpr int kKV = kSlabs * kKeys * kRowBytes;
  static constexpr int kRowTile = kSlabs * kRows * kRowBytes;
  static constexpr int kDs = kKeys * kRows * 2;
  // up to 64 dims a tile's dq (kRows x hd float32) is staged in the ds^T
  // buffer its product has read; above, in a buffer of each warpgroup's own
  static constexpr int kDq = HD <= kSlab ? 0 : kRows * dq_cols(HD) * 4;
  static constexpr int kInfoBytes = 3 * kRows * 4;
  static constexpr int kStage = 2 * kRowTile + (kInfoBytes + kAlign - 1) / kAlign * kAlign;
  static constexpr int bytes(int stages) {
    return kAlign + 2 * kKV + 2 * (kDs + kDq) + stages * kStage + kBarrierBytes;
  }
  static_assert(HD > kSlab || kRows * dq_cols(HD) * 4 <= kDs, "dq fits in a ds^T buffer");
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

// One bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple of
// 16) into dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// N threads (the consumer warpgroups, or one of them), and no other thread,
// meet at named barrier `id` (0 is __syncthreads); arrive passes on
// without waiting.  Barriers: 1 the consumers, 2 + o and 4 + o ds^T
// buffer o's (written, read), 6 + wg warpgroup wg's own.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Generic-proxy stores to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Keep the compiler from moving reads or writes of these registers across
// the (volatile) wgmma issue and wait statements.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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

// d (64 x N) += a . b; a in registers (per warp, the A layout of
// mma.m16n8k16), b an MN-major bf16 tile in shared memory.  One
// specialisation a head dim, N = HD: the accumulator d is N / 2 registers
// (%0 ...), then come a's four registers, b's descriptor and the operand
// that sets the accumulate predicate; REGS lists the accumulator operands
// and TAIL numbers the rest.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// d[0, N / 2) (64 x N) = a . b (accumulate = 0) or += it; a and b bf16
// tiles in shared memory read through descriptors, both K-major (T = 0) or
// both MN-major (T = 1: a's M and b's N contiguous).
template <int N, int T>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate);

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
#define WGMMA_SS(N, T, REGS, TAIL, PRED, ...)                                               \
  template <>                                                                                \
  __device__ __forceinline__ void wgmma_ss<N, T>(float* d, uint64_t a, uint64_t b,           \
                                                 int accumulate) {                           \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " PRED ", 0;\n"                        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " TAIL \
                 ", p, 1, 1, " #T ", " #T ";\n}\n"                                            \
                 : __VA_ARGS__                                                               \
                 : "l"(a), "l"(b), "r"(accumulate));                                         \
  }
#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D8(i) D4(i), D4(i + 4)
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
WGMMA_SS(64, 0, R32, "%32, %33", "%34", D8(0), D8(8), D8(16), D8(24))
WGMMA_SS(16, 1, R8, "%8, %9", "%10", D8(0))
WGMMA_SS(32, 1, R16, "%16, %17", "%18", D8(0), D8(8))
WGMMA_SS(48, 1, R24, "%24, %25", "%26", D8(0), D8(8), D8(16))
WGMMA_SS(64, 1, R32, "%32, %33", "%34", D8(0), D8(8), D8(16), D8(24))
#undef WGMMA_RS
#undef WGMMA_SS
#undef D4
#undef D8
#undef R8
#undef R16
#undef R24
#undef R32
#undef R40
#undef R48
#undef R56
#undef R64

// The pre-pass over one row tile of one kv head of one batch row: each
// slot's record (lse in log2 units, delta, query position; an empty slot or
// one past Sq gets lse = +inf and delta 0), the tile's query position range
// over its real slots, and its rows of the dq workspace zeroed.  Four
// threads a slot, all 64 slots at once, 16-byte loads.
__global__ void __launch_bounds__(kPrepThreads)
    flash_attention_bwd_prep_kernel(const PrepParams p) {
  constexpr int kWarps = kPrepThreads / 32;
  __shared__ int lo_s[kWarps], hi_s[kWarps];
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z, part = threadIdx.x % 4;
  const int nq = dq_cols(p.hd), chunks = (p.hd + nq - 1) / nq;
  float* rec = p.info + (((size_t)b * p.Hkv + g) * p.tiles + tile) * 3 * kRows;
  int lo = INT_MAX, hi = INT_MIN;
  for (int s = threadIdx.x / 4; s < kRows; s += kPrepThreads / 4) {
    const int t = tile * p.tokens + s / p.rep, h = g * p.rep + s % p.rep;
    const bool ok = s < p.tokens * p.rep && t < p.Sq;
    float acc = 0.f;
    int qp = 0;
    if (ok) {
      const size_t row = ((size_t)b * p.Sq + t) * p.Hp + h;
      const uint4* o = reinterpret_cast<const uint4*>(p.out + row * p.hd);
      const uint4* d = reinterpret_cast<const uint4*>(p.dout + row * p.hd);
      for (int c = part; c < p.hd / 8; c += 4) {  // 8 columns a step
        const uint4 ov = o[c], dv = d[c];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
          const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[w]));
          acc += df.x * of.x + df.y * of.y;
        }
      }
      const size_t wrow = (((size_t)b * p.Hkv + g) * chunks * p.Sq + t) * p.rep + h % p.rep;
      for (int c = part; c < chunks * nq / 4; c += 4)
        reinterpret_cast<float4*>(
            p.dq_ws + (wrow + (size_t)(4 * c / nq) * p.Sq * p.rep) * nq)[4 * c % nq / 4] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      qp = p.q_pos[(size_t)b * p.Sq + t];
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      rec[s] = ok ? (float)(p.lse[((size_t)b * p.Hp + h) * p.Sq + t] * kLog2e) : INFINITY;
      rec[kRows + s] = acc;
      reinterpret_cast<int*>(rec)[2 * kRows + s] = qp;
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    lo_s[threadIdx.x / 32] = lo;
    hi_s[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, lo_s[w]);
      hi = max(hi, hi_s[w]);
    }
    p.range[((size_t)b * p.Hkv + g) * p.tiles + tile] = make_int2(lo, hi);
  }
}

// The last step: dq, the float32 workspace rounded to bf16 into dq's
// (B, Sq, Hp, hd) layout, four values a thread.
__global__ void __launch_bounds__(kDqThreads)
    flash_attention_bwd_dq_kernel(const float* __restrict__ ws, uint2* __restrict__ dq,
                                  size_t n4, int Sq, int Hp, int Hkv, int hd, int tokens) {
  const int rep = Hp / Hkv, nq = dq_cols(hd), chunks = (hd + nq - 1) / nq;
  for (size_t i = (size_t)blockIdx.x * kDqThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kDqThreads) {
    const int col = (int)(i % (hd / 4)) * 4;
    const size_t row = i / (hd / 4);  // (b, t, h)
    const int h = (int)(row % Hp), t = (int)(row / Hp % Sq);
    const size_t b = row / Hp / Sq;
    const int slot = t % tokens * rep + h % rep;  // in its row tile
    const float4 a = *reinterpret_cast<const float4*>(
        ws + ((((b * Hkv + h / rep) * chunks + col / nq) * Sq + t) * rep + h % rep) * nq +
        dq_col_at(col % nq, slot, nq));
    dq[i] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// dq (64 slots x N columns) = ds (64 slots x kKeys keys: a 64-slot slab of
// a ds^T buffer, read MN-major) . K (the K tile's columns, read MN-major),
// issued into dq[0, N / 2); the caller commits.
template <int N, int M>
__device__ __forceinline__ void dq_issue(float (&dq)[M], uint64_t ds_desc, uint64_t kq_desc) {
  static_assert(N / 2 <= M, "dq holds the share");
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t step = (uint64_t)((kk * 16 * kRowBytes) >> 4);
    wgmma_ss<N, 1>(dq, ds_desc + step, kq_desc + step, kk > 0);
  }
}

// A warpgroup's dq accumulator (64 slots x N columns) stored to shared
// memory at `buf`, rows of N float32 as the workspace lays them out
// (dq_col_at: this thread's rows are slots 16 w + gq and + 8).
template <int N, int M>
__device__ __forceinline__ void dq_stage(const float (&dq)[M], uint32_t buf) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4, slot = w * 16 + (lane >> 2);
  const uint32_t row = buf + slot * N * 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t at = row + dq_col_at(8 * j + 2 * (lane & 3), slot, N) * 4;
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(dq[4 * j]),
                 "f"(dq[4 * j + 1])
                 : "memory");
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at + 8 * N * 4),
                 "f"(dq[4 * j + 2]), "f"(dq[4 * j + 3])
                 : "memory");
  }
}

// `bytes` of float32 at shared `src` added into global `dst` by the bulk
// copy engine, as one group of this thread's.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_kernel(const __grid_constant__ Params p) {
  using L = Smem<HD>;
  constexpr int kSlabs = L::kSlabs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t k_tile = base, v_tile = base + L::kKV, ds_tile = base + 2 * L::kKV;
  const uint32_t dq_tile = ds_tile + 2 * L::kDs;
  const uint32_t ring = dq_tile + 2 * L::kDq;
  const uint32_t bars = ring + p.stages * L::kStage;
  auto q_tile = [&](int s) { return ring + s * L::kStage; };
  auto do_tile = [&](int s) { return ring + s * L::kStage + L::kRowTile; };
  auto info_tile = [&](int s) { return ring + s * L::kStage + 2 * L::kRowTile; };
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kMaxStages + s); };

  // Block order: key tiles outermost, then kv head and batch row, so that
  // under a causal mask the heaviest blocks (the first keys) go first.
  const int units = p.Hkv * p.B;
  const int kt = blockIdx.x / units, unit = blockIdx.x % units;
  const int g = unit % p.Hkv, b = unit / p.Hkv;
  const int key0 = kt * kKeys;
  const int kv_end = max(0, min(p.kv_valid[b], p.Skv));
  const bool any = key0 < kv_end;  // the block has a key some query may see
  const int key_last = min(key0 + kKeys, kv_end) - 1;
  const int2* range = p.range + ((size_t)b * p.Hkv + g) * p.tiles;
  const float* info = p.info + ((size_t)b * p.Hkv + g) * p.tiles * 3 * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a row tile that some slot of it may see some key of the block in
  auto needed = [&](int tile) {
    const int2 r = range[tile];
    return (!p.causal || r.y >= key0) && (p.window <= 0 || r.x - p.window < key_last);
  };

  if (threadIdx.x == 0) {
    barrier_init(kv_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      barrier_init(full(s), 1);
      barrier_init(empty(s), kConsumers / 32);  // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: its first warp's lane 0 issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0 || !any) return;
    arrive_expect_tx(kv_full, 2 * L::kKV);
    for (int c = 0; c < kSlabs; ++c) {
      tma_load(k_tile + c * kKeys * kRowBytes, &p.k_map, c * kSlab, g, key0, b, kv_full);
      tma_load(v_tile + c * kKeys * kRowBytes, &p.v_map, c * kSlab, g, key0, b, kv_full);
    }
    const int box = kSlabs * p.rep * p.tokens * kRowBytes;
    for (int tile = 0, i = 0; tile < p.tiles; ++tile) {
      if (!needed(tile)) continue;
      const int s = i % p.stages;
      wait_phase(empty(s), ((i / p.stages) & 1) ^ 1);  // the first round passes at once
      arrive_expect_tx(full(s), 2 * box + L::kInfoBytes);
      for (int c = 0; c < kSlabs; ++c) {
        tma_load(q_tile(s) + c * kRows * kRowBytes, &p.q_map, c * kSlab, g * p.rep,
                 tile * p.tokens, b, full(s));
        tma_load(do_tile(s) + c * kRows * kRowBytes, &p.do_map, c * kSlab, g * p.rep,
                 tile * p.tokens, b, full(s));
      }
      bulk_load(info_tile(s), info + (size_t)tile * 3 * kRows, L::kInfoBytes, full(s));
      ++i;
    }
    wait_phase(kv_full, 0);  // the K and V copies land before the block ends
    return;
  }

  // Consumer warpgroups: warpgroup wg owns keys [64 wg, 64 wg + 64) of the
  // block; this thread holds keys kr and kr + 8 (the m64nN accumulator's
  // rows) and slots 8 j + 2 tq, + 1 (its columns).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int gq = lane >> 2, tq = lane & 3, wq = warp % 4;
  const int slots = p.tokens * p.rep;

  // The slots past tokens x rep of every stage's q and dout tiles are never
  // written by a copy: zero them once, so that they multiply as zeros.
  if (slots < kRows) {
    const int chunks = p.stages * 2 * kSlabs * (kRows - slots) * 8;  // 16-byte chunks
    for (int c = threadIdx.x; c < chunks; c += kConsumers) {
      const int line = slots + c / 8 % (kRows - slots);
      const int tile = c / 8 / (kRows - slots);  // (stage, q or dout, slab)
      const uint32_t at = ring + tile / (2 * kSlabs) * L::kStage +
                          tile % (2 * kSlabs) * kRows * kRowBytes + line * kRowBytes + c % 8 * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
    }
    fence_async_smem();
  }
  named_sync<kConsumers>(1);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  if (any) {
    // dq: up to 64 dims one warpgroup takes all of a tile's columns, the
    // tiles alternating between the two (kOwner: neither waits for the
    // other's products, so one's exp and stores run beside the other's
    // products); above, warpgroup wg takes columns [64 wg, 64 wg + 64) of
    // every tile (those past hd read K's zeros and are not added)
    constexpr bool kOwner = HD <= kSlab;
    constexpr int NQ = dq_cols(HD);  // dq columns a product
    const int col0 = kOwner ? 0 : wg * kSlab;
    // this warpgroup's chunk of the dq workspace, at the kv head's row 0
    float* const dq_rows =
        p.dq_ws + (((size_t)b * p.Hkv + g) * (kOwner ? 1 : 2) + col0 / NQ) * p.Sq * p.rep * NQ;
    // descriptors: this warpgroup's 64 keys of K and V (K-major A), q and
    // dout (K-major B for s^T and dp^T, MN-major B for dk and dv), the ds^T
    // buffers (MN-major A) and K's columns of dq's product (MN-major B)
    const uint64_t k_desc = descriptor(k_tile + wg * 64 * kRowBytes, 16, 8 * kRowBytes);
    const uint64_t v_desc = descriptor(v_tile + wg * 64 * kRowBytes, 16, 8 * kRowBytes);
    const uint64_t kq_desc =
        descriptor(k_tile + col0 / kSlab * kKeys * kRowBytes, kKeys * kRowBytes, 8 * kRowBytes);
    auto kv_step = [](int kk) {
      return (uint64_t)(((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4);
    };
    auto row_step = [](int kk) {
      return (uint64_t)(((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4);
    };
    const int kr = key0 + wg * 64 + wq * 16 + gq;  // this thread's first key
    const float scale = p.scale, scale2 = p.scale2;
    float s[kRows / 2], dp[kRows / 2];
    // whether the block needs row tile t, uniform to the compiler (a
    // broadcast), so that no wgmma sits under a condition it cannot see is
    // uniform across the warpgroup
    auto need_u = [&](int t) { return __shfl_sync(0xffffffffu, (int)needed(t), 0); };
    int n = 0;  // the tiles the block walks
    for (int t = 0; t < p.tiles; ++t) n += need_u(t);
    // s^T = K q^T and dp^T = V dout^T of the i-th tile walked (ring stage
    // st): 64 keys x kRows slots, two groups.  No wgmma is in flight here:
    // the accumulators are cleared by plain moves, which end what they held
    // for the compiler (a wgmma operand reads its accumulator, so the last
    // tile's values would stay live).
    auto issue_sdp = [&](int i) {
      const int st = i % p.stages;
#pragma unroll
      for (int e = 0; e < kRows / 2; ++e) s[e] = dp[e] = 0.f;
      wait_phase(full(st), (i / p.stages) & 1);
      const uint64_t q_desc = descriptor(q_tile(st), 16, 8 * kRowBytes);
      const uint64_t o_desc = descriptor(do_tile(st), 16, 8 * kRowBytes);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kRows, 0>(s, k_desc + kv_step(kk), q_desc + row_step(kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kRows, 0>(dp, v_desc + kv_step(kk), o_desc + row_step(kk), kk > 0);
      wgmma_commit();
    };
    wait_phase(kv_full, 0);

    // (kOwner) a tile's dq leaves from the ds^T buffer its product read; the
    // buffer is handed back to the other warpgroup at this warpgroup's next
    // tile, once the bulk copy has read it
    bool sent = false;
    int sent_buf = 0, staged = 0;
    int tile = 0;
    while (tile < p.tiles && !need_u(tile)) ++tile;
    for (int i = 0; i < n; ++i) {
      // the tile's ds^T buffer o, and (kOwner) the warpgroup that takes its
      // dq; named barriers 2 + o (both halves of buffer o written), 4 + o
      // (buffer o free again) and 6 + wg (this warpgroup's own)
      const int o = i & 1;
      issue_sdp(i);
      const int2 r = range[tile];
      const int whole = __shfl_sync(
          0xffffffffu,
          (int)(key0 + kKeys <= kv_end && (!p.causal || key0 + kKeys - 1 <= r.x) &&
                (p.window <= 0 || key0 > r.y - p.window)),
          0);
      const int st = i % p.stages;
      const uint32_t ds_buf = ds_tile + o * L::kDs;
      const float* rec = reinterpret_cast<const float*>(smem_raw + (info_tile(st) - raw));
      const int* qpos = reinterpret_cast<const int*>(rec + 2 * kRows);

      // p^T while dp^T runs: element e is key kr + 8 ((e >> 1) & 1), slot
      // 8 (e >> 2) + 2 tq + (e & 1)
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rec + 8 * j + 2 * tq);
        const int2 qv = *reinterpret_cast<const int2*>(qpos + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int key = kr + 8 * ((e >> 1) & 1), qp = e & 1 ? qv.y : qv.x;
          const bool in = whole || (key < kv_end && (!p.causal || key <= qp) &&
                                    (p.window <= 0 || key > qp - p.window));
          s[e] = in ? ex2(fmaf(s[e], scale2, -(e & 1 ? l2.y : l2.x))) : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // ds^T; p^T and ds^T rounded to bf16 as the A fragments of dv and dk
      uint32_t pf[kRows / 16][4], sf[kRows / 16][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(rec + kRows + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e)
          dp[e] = s[e] * (dp[e] - (e & 1 ? dl.y : dl.x)) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          pf[kk][jj] = pack_bf16(s[8 * kk + 2 * jj], s[8 * kk + 2 * jj + 1]);
          sf[kk][jj] = pack_bf16(dp[8 * kk + 2 * jj], dp[8 * kk + 2 * jj + 1]);
        }
      if (kOwner && sent) {
        // the bulk copy of this warpgroup's last dq has read buffer
        // sent_buf: hand it back to the other warpgroup, whose next tile
        // writes its half there
        if (wq == 0 && lane == 0) bulk_wait_read();
        named_sync<128>(6 + wg);
        if (i + 1 < n) named_arrive<kConsumers>(4 + sent_buf);
        sent = false;
      }
      // this warpgroup's keys of ds^T into buffer o: line = key (low 3 bits
      // gq), slots 8 j + 2 tq, + 1 in the swizzled 16-byte chunk j
      if (kOwner && wg != o && i >= 2) named_sync<kConsumers>(4 + o);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 2 * kk + (jj >> 1), line = wg * 64 + wq * 16 + gq + 8 * (jj & 1);
          const uint32_t at = ds_buf + line * kRowBytes + ((j ^ gq) << 4) + 4 * tq;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(sf[kk][jj]) : "memory");
        }
      fence_async_smem();

      // dv += bf16(p^T) dout and dk += bf16(ds^T) q over the tile's slots
      const uint64_t o_mn = descriptor(do_tile(st), kRows * kRowBytes, 8 * kRowBytes);
      const uint64_t q_mn = descriptor(q_tile(st), kRows * kRowBytes, 8 * kRowBytes);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs<HD>(dv, pf[kk], o_mn + (uint64_t)((kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs<HD>(dk, sf[kk], q_mn + (uint64_t)((kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
      // dq += bf16(ds) K, once every part of ds^T is in the buffer
      float dq[NQ / 2];
      const bool mine = !kOwner || wg == o;
      if (mine) {
        named_sync<kConsumers>(kOwner ? 2 + o : 1);
        wgmma_fence();
        dq_issue<NQ>(dq, descriptor(ds_buf, kKeys * kRowBytes, 8 * kRowBytes), kq_desc);
        wgmma_commit();
      } else {
        named_arrive<kConsumers>(2 + o);
      }
      wgmma_wait<0>();  // dv, dk and dq are done
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      fence_frags(pf);
      fence_frags(sf);
      if (lane == 0) arrive(empty(st));  // q, dout and the record are read
      if (mine) {
        // dq's rows of the tile into the workspace: one bulk reduction of
        // the rows [r0, r0 + nvalid) of this warpgroup's chunk
        const int r0 = tile * p.tokens * p.rep, nvalid = min(slots, p.Sq * p.rep - r0);
        const uint32_t buf = kOwner ? ds_buf : dq_tile + wg * L::kDq;
        if (!kOwner && staged++ > 0) {  // the last copy out of the buffer has read it
          if (wq == 0 && lane == 0) bulk_wait_read();
          named_sync<128>(6 + wg);
        }
        dq_stage<NQ>(dq, buf);
        fence_async_smem();
        named_sync<128>(6 + wg);
        if (wq == 0 && lane == 0) bulk_reduce_add(dq_rows + (size_t)r0 * NQ, buf, nvalid * NQ * 4);
        sent = kOwner;
        sent_buf = o;
      }
      do ++tile;
      while (tile < p.tiles && !need_u(tile));
    }
    // the reductions are done before the block ends
    if (wq == 0 && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }

  // dk and dv: this thread's keys kr and kr + 8, columns 8 j + 2 tq and + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + wg * 64 + wq * 16 + gq + 8 * half;
    if (key >= p.Skv) continue;
    const size_t at = (((size_t)b * p.Skv + key) * p.Hkv + g) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(p.dk + at + 8 * j) =
          pack_bf16(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + at + 8 * j) =
          pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
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
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, const void* q_pos, const void* kv_valid, void* ws, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hp, int Hkv, int causal, int window,
           cudaStream_t stream) {
  using L = Smem<HD>;
  Layout lay;
  if (Skv <= 0 || !layout(B, Sq, Hp, Hkv, HD, &lay)) return (int)cudaErrorInvalidValue;
  const int rep = lay.rep, tokens = lay.tokens, tiles = lay.tiles;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // The tensor maps are encoded through the driver, which needs a context
  // current in this thread; autograd runs the backward on a thread of its
  // own, where no runtime call may have made one current yet.  Setting the
  // thread's current device (the wrapper's choice) again makes its primary
  // context current and changes no device.
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{};
  if (!encode_map(encode, &p.q_map, q, HD, Hp, Sq, B, rep, tokens) ||
      !encode_map(encode, &p.do_map, dout, HD, Hp, Sq, B, rep, tokens) ||
      !encode_map(encode, &p.k_map, k, HD, Hkv, Skv, B, 1, kKeys) ||
      !encode_map(encode, &p.v_map, v, HD, Hkv, Skv, B, 1, kKeys))
    return (int)cudaErrorInvalidValue;
  const size_t rows_all = (size_t)B * Sq * Hp;
  float* dq_ws = static_cast<float*>(ws);
  float* info = dq_ws + lay.dq_floats;
  int2* range = reinterpret_cast<int2*>(info + lay.info_floats);

  PrepParams pp{};
  pp.out = static_cast<const bf16*>(out);
  pp.dout = static_cast<const bf16*>(dout);
  pp.lse = static_cast<const float*>(lse);
  pp.q_pos = static_cast<const int*>(q_pos);
  pp.info = info;
  pp.range = range;
  pp.dq_ws = dq_ws;
  pp.Sq = Sq;
  pp.Hp = Hp;
  pp.Hkv = Hkv;
  pp.rep = rep;
  pp.tokens = tokens;
  pp.tiles = tiles;
  pp.hd = HD;
  flash_attention_bwd_prep_kernel<<<dim3(tiles, Hkv, B), kPrepThreads, 0, stream>>>(pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  p.info = info;
  p.range = range;
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.dq_ws = dq_ws;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hp = Hp;
  p.Hkv = Hkv;
  p.rep = rep;
  p.tokens = tokens;
  p.tiles = tiles;
  p.stages = std::min(kMaxStages, (kSmemMax - L::bytes(0)) / L::kStage);
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / std::sqrt((double)HD));
  p.scale2 = (float)(kLog2e / std::sqrt((double)HD));
  const int smem = L::bytes(p.stages);
  err = cudaFuncSetAttribute(flash_attention_bwd_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (Skv + kKeys - 1) / kKeys;
  flash_attention_bwd_kernel<HD><<<key_tiles * Hkv * B, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t n4 = rows_all * HD / 4;
  const int blocks = (int)std::min<size_t>((n4 + kDqThreads - 1) / kDqThreads, 132 * 16);
  flash_attention_bwd_dq_kernel<<<blocks, kDqThreads, 0, stream>>>(
      dq_ws, static_cast<uint2*>(dq), n4, Sq, Hp, Hkv, HD, tokens);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The float32 floats of the workspace a launch at these shapes takes (the
// wrapper allocates it; the pre-pass zeroes what must start at zero); 0
// for shapes the kernels do not take (Layout's refusals).
size_t flash_attention_bwd_workspace(int B, int Sq, int Hp, int Hkv, int hd) {
  Layout lay;
  return layout(B, Sq, Hp, Hkv, hd, &lay) ? lay.floats() : 0;
}

// Returns the CUDA error of the launches (0 = launched): the pre-pass, the
// main kernel, then dq's rounding, on `stream`, on the thread's current
// device.  ws holds flash_attention_bwd_workspace(B, Sq, Hp, Hkv, hd)
// floats.  cudaErrorInvalidValue for shapes the kernels do not take.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const void* lse, const void* q_pos,
                               const void* kv_valid, void* ws, void* dq, void* dk, void* dv,
                               int B, int Sq, int Skv, int Hp, int Hkv, int hd, int causal,
                               int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_CASE(HD)                                                                       \
  case HD:                                                                                 \
    return launch<HD>(q, k, v, out, dout, lse, q_pos, kv_valid, ws, dq, dk, dv, B, Sq, Skv, \
                      Hp, Hkv, causal, window, s);
  switch (hd) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // extern "C"
