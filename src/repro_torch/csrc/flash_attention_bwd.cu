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
//   lse, delta (B, Hp, Sq) float32   q_pos (B, Sq) int32   kv_valid (B,) int32
// hd is a multiple of 16 up to 128.
//
// What bounds it on this card: bf16 tensor-core operations, five products
// of 2 hd flops over every visible (query, key) pair (s, dp, dv, dq, dk),
// against q, k, v, out, dout, lse read once and dq, dk, dv written once.
// At SmolLM-135M's training shape (B 8, L 2,048, 9 heads of 64, causal)
// that is 5 x 2 x 64 x 9 x 8 x 2,098,176 = 96.7 GFLOP, 0.098 ms at 989
// TFLOP/s, against 101 MB, 0.030 ms at 3.35 TB/s.
//
// The design: simple and right first (FA2's split of the work).
// - delta: one warp a row (b, i, h) sums dout . out in float32.
// - dK and dV: one block of four warps per (64-key tile, kv head, batch
//   row); warp w owns keys [16 w, 16 w + 16) of the tile.  The block walks
//   the (query, head) rows of its kv head, r = i rep + h % rep, in tiles of
//   64 rows (32 at hd > 64, for registers), skipping a tile whose rows all
//   mask the block's keys (causal diagonal, window, kv_valid).  Each warp
//   forms s^T = k q^T and dp^T = v dout^T for its 16 keys, p^T and ds^T in
//   registers, and accumulates dv += bf16(p^T) dout and dk += bf16(ds^T) q in
//   registers: the rep heads' rows are rows of the same walk, so the head
//   sum is part of the product and needs no atomics.
// - dQ: one block of four warps per (64-row tile of (query, head) rows, kv
//   head, batch row), warp w owning 16 rows; it walks the key tiles its rows
//   can see, recomputing s and dp, and accumulates dq += bf16(ds) k.  The
//   two kernels each recompute s and dp (seven products in all against the
//   five the bound counts); that buys dq without atomics, and a result that
//   repeats bit for bit.
// - Products: mma.sync m16n8k16, bf16 in, float32 accumulate.  Tiles are
//   staged in shared memory with rows padded by 16 bytes; an accumulator
//   (p^T, ds^T, ds) is re-packed in registers as the A operand of the next
//   product; the B operands that walk rows of a tile (dout, q, k along the
//   reduction) are gathered two 16-bit loads a register.  No TMA, no wgmma,
//   no pipelining of the loads: that is later work.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps
constexpr int kKeyTile = 64;   // keys a dK/dV block; keys a step of the dQ walk
constexpr int kRowTile = 64;   // (query, head) rows a dQ block
constexpr int kPad = 8;        // bf16 elements a shared-memory row is padded by
constexpr int kDeltaWarps = 8;

struct Params {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  const float* delta;
  const int* q_pos;
  const int* kv_valid;
  bf16 *dq, *dk, *dv;
  int B, Sq, Skv, Hp, Hkv, rep, causal, window;
  float scale;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Two consecutive bf16 of a row of a shared-memory tile (row stride LD).
template <int LD>
__device__ __forceinline__ uint32_t row_pair(const bf16* t, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(t + r * LD + c);
}

// Element (r, c) in the low half, (r + 1, c) in the high half.
template <int LD>
__device__ __forceinline__ uint32_t col_pair(const bf16* t, int r, int c) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(t + r * LD + c);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(t + (r + 1) * LD + c);
  return lo | hi << 16;
}

// Rows [0, n) of a tile: row i from src(i) (a global row of HD bf16, or null
// for a zero row), 16 bytes a thread at a time.
template <int HD, int LD, typename Src>
__device__ __forceinline__ void load_rows(bf16* tile, int n, Src src) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < n * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bf16* g = src(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g != nullptr) val = *reinterpret_cast<const uint4*>(g + c);
    *reinterpret_cast<uint4*>(tile + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int key, int kv_end, int qp) {
  return key < kv_end && (!p.causal || key <= qp) && (p.window <= 0 || key > qp - p.window);
}

// delta[b, h, i] = sum_d dout[b, i, h, d] out[b, i, h, d], one warp a row.
__global__ void __launch_bounds__(kDeltaWarps * 32)
    flash_attention_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                     float* __restrict__ delta, int rows_all, int Sq, int Hp,
                                     int hd) {
  const int row = blockIdx.x * kDeltaWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows_all) return;
  const bf16* o = out + (size_t)row * hd;
  const bf16* d = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc += __bfloat162float(d[c]) * __bfloat162float(o[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % Hp, i = row / Hp % Sq, b = row / Hp / Sq;
    delta[((size_t)b * Hp + h) * Sq + i] = acc;
  }
}

template <int HD>
struct Dims {
  static constexpr int LD = HD + kPad;
  static constexpr int QT = HD <= 64 ? 64 : 32;  // (query, head) rows a step of the dK/dV walk
  static constexpr int kv_smem = (2 * kKeyTile + 2 * QT) * LD * 2 + QT * 16;
  static constexpr int q_smem = (2 * kRowTile + 2 * kKeyTile) * LD * 2 + kRowTile * 16;
};

// dK and dV of one 64-key tile of one kv head of one batch row.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kv_kernel(const Params p) {
  using D = Dims<HD>;
  constexpr int LD = D::LD, QT = D::QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeyTile * LD;
  bf16* qs = vs + kKeyTile * LD;
  bf16* dos = qs + QT * LD;
  float* lse_s = reinterpret_cast<float*>(dos + QT * LD);
  float* delta_s = lse_s + QT;
  int* qpos_s = reinterpret_cast<int*>(delta_s + QT);
  int* ok_s = qpos_s + QT;

  const int key0 = blockIdx.x * kKeyTile, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int kv_end = min(p.kv_valid[b], p.Skv);
  const int rows_all = p.Sq * p.rep;
  const size_t kv_row0 = (size_t)b * p.Skv;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (key0 < kv_end) {
    load_rows<HD, LD>(ks, kKeyTile, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < p.Skv ? p.k + ((kv_row0 + key) * p.Hkv + g) * HD : nullptr;
    });
    load_rows<HD, LD>(vs, kKeyTile, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < p.Skv ? p.v + ((kv_row0 + key) * p.Hkv + g) * HD : nullptr;
    });
    const int key_last = min(key0 + kKeyTile, kv_end) - 1;
    for (int r0 = 0; r0 < rows_all; r0 += QT) {
      __syncthreads();  // the last step's tiles are no longer read
      bool need = false;
      for (int i = threadIdx.x; i < QT; i += kThreads) {
        const int r = r0 + i;
        const bool ok = r < rows_all;
        const int t = ok ? r / p.rep : 0, h = g * p.rep + (ok ? r % p.rep : 0);
        const int qp = ok ? p.q_pos[(size_t)b * p.Sq + t] : 0;
        qpos_s[i] = qp;
        ok_s[i] = ok;
        lse_s[i] = ok ? p.lse[((size_t)b * p.Hp + h) * p.Sq + t] : 0.f;
        delta_s[i] = ok ? p.delta[((size_t)b * p.Hp + h) * p.Sq + t] : 0.f;
        need |= ok && (!p.causal || qp >= key0) && (p.window <= 0 || key_last > qp - p.window);
      }
      if (!__syncthreads_or(need)) continue;
      load_rows<HD, LD>(qs, QT, [&](int i) -> const bf16* {
        const int r = r0 + i;
        if (r >= rows_all) return nullptr;
        return p.q + (((size_t)b * p.Sq + r / p.rep) * p.Hp + g * p.rep + r % p.rep) * HD;
      });
      load_rows<HD, LD>(dos, QT, [&](int i) -> const bf16* {
        const int r = r0 + i;
        if (r >= rows_all) return nullptr;
        return p.dout + (((size_t)b * p.Sq + r / p.rep) * p.Hp + g * p.rep + r % p.rep) * HD;
      });
      __syncthreads();

      // s^T = k q^T and dp^T = v dout^T: this warp's 16 keys x QT rows
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      const int kr = warp * 16 + gq;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * tq;
        const uint32_t ak[4] = {row_pair<LD>(ks, kr, c), row_pair<LD>(ks, kr + 8, c),
                                row_pair<LD>(ks, kr, c + 8), row_pair<LD>(ks, kr + 8, c + 8)};
        const uint32_t av[4] = {row_pair<LD>(vs, kr, c), row_pair<LD>(vs, kr + 8, c),
                                row_pair<LD>(vs, kr, c + 8), row_pair<LD>(vs, kr + 8, c + 8)};
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          mma(st[j], ak, row_pair<LD>(qs, j * 8 + gq, c), row_pair<LD>(qs, j * 8 + gq, c + 8));
          mma(dpt[j], av, row_pair<LD>(dos, j * 8 + gq, c), row_pair<LD>(dos, j * 8 + gq, c + 8));
        }
      }
      // p^T into st, ds^T into dpt
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + kr + (e >> 1) * 8, ri = j * 8 + 2 * tq + (e & 1);
          const bool in = ok_s[ri] && visible(p, key, kv_end, qpos_s[ri]);
          const float pr = in ? expf(st[j][e] * p.scale - lse_s[ri]) : 0.f;
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - delta_s[ri]) * p.scale;
        }
      // dv += bf16(p^T) dout, dk += bf16(ds^T) q over the QT rows
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t as[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        const int r = kk * 16 + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int c = n * 8 + gq;
          mma(dv[n], ap, col_pair<LD>(dos, r, c), col_pair<LD>(dos, r + 8, c));
          mma(dk[n], as, col_pair<LD>(qs, r, c), col_pair<LD>(qs, r + 8, c));
        }
      }
    }
  }
  // this thread's keys kr and kr + 8, columns 8 n + 2 tq and + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + warp * 16 + gq + 8 * half;
    if (key >= p.Skv) continue;
    const size_t at = ((kv_row0 + key) * p.Hkv + g) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(p.dk + at + n * 8) =
          pack_bf16(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + at + n * 8) =
          pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dQ of one tile of 64 (query, head) rows of one kv head of one batch row.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_q_kernel(const Params p) {
  using D = Dims<HD>;
  constexpr int LD = D::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRowTile * LD;
  bf16* ks = dos + kRowTile * LD;
  bf16* vs = ks + kKeyTile * LD;
  float* lse_s = reinterpret_cast<float*>(vs + kKeyTile * LD);
  float* delta_s = lse_s + kRowTile;
  int* qpos_s = reinterpret_cast<int*>(delta_s + kRowTile);
  int* ok_s = qpos_s + kRowTile;
  __shared__ int range[2];  // the rows' smallest and largest query position

  const int r0 = blockIdx.x * kRowTile, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int rows_all = p.Sq * p.rep;
  const int kv_end = min(p.kv_valid[b], p.Skv);
  const size_t kv_row0 = (size_t)b * p.Skv;
  auto row_at = [&](int r) -> size_t {
    return ((size_t)b * p.Sq + r / p.rep) * p.Hp + g * p.rep + r % p.rep;
  };

  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowTile; i += kThreads) {
    const int r = r0 + i;
    const bool ok = r < rows_all;
    const int t = ok ? r / p.rep : 0, h = g * p.rep + (ok ? r % p.rep : 0);
    const int qp = ok ? p.q_pos[(size_t)b * p.Sq + t] : 0;
    qpos_s[i] = qp;
    ok_s[i] = ok;
    lse_s[i] = ok ? p.lse[((size_t)b * p.Hp + h) * p.Sq + t] : 0.f;
    delta_s[i] = ok ? p.delta[((size_t)b * p.Hp + h) * p.Sq + t] : 0.f;
    if (ok) {
      atomicMin(&range[0], qp);
      atomicMax(&range[1], qp);
    }
  }
  load_rows<HD, LD>(qs, kRowTile, [&](int i) -> const bf16* {
    return r0 + i < rows_all ? p.q + row_at(r0 + i) * HD : nullptr;
  });
  load_rows<HD, LD>(dos, kRowTile, [&](int i) -> const bf16* {
    return r0 + i < rows_all ? p.dout + row_at(r0 + i) * HD : nullptr;
  });
  __syncthreads();
  const int qmin = range[0], qmax = range[1];
  const int hi = p.causal ? min(kv_end, qmax + 1) : kv_end;
  const int lo = p.window > 0 ? max(0, qmin - p.window + 1) : 0;

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const int qr = warp * 16 + gq;

  for (int key0 = lo / kKeyTile * kKeyTile; key0 < hi; key0 += kKeyTile) {
    __syncthreads();  // the last tile is no longer read
    load_rows<HD, LD>(ks, kKeyTile, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < p.Skv ? p.k + ((kv_row0 + key) * p.Hkv + g) * HD : nullptr;
    });
    load_rows<HD, LD>(vs, kKeyTile, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < p.Skv ? p.v + ((kv_row0 + key) * p.Hkv + g) * HD : nullptr;
    });
    __syncthreads();

    // s = q k^T and dp = dout v^T: this warp's 16 rows x 64 keys
    float s[kKeyTile / 8][4], dp[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + 2 * tq;
      const uint32_t aq[4] = {row_pair<LD>(qs, qr, c), row_pair<LD>(qs, qr + 8, c),
                              row_pair<LD>(qs, qr, c + 8), row_pair<LD>(qs, qr + 8, c + 8)};
      const uint32_t ad[4] = {row_pair<LD>(dos, qr, c), row_pair<LD>(dos, qr + 8, c),
                              row_pair<LD>(dos, qr, c + 8), row_pair<LD>(dos, qr + 8, c + 8)};
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        mma(s[j], aq, row_pair<LD>(ks, j * 8 + gq, c), row_pair<LD>(ks, j * 8 + gq, c + 8));
        mma(dp[j], ad, row_pair<LD>(vs, j * 8 + gq, c), row_pair<LD>(vs, j * 8 + gq, c + 8));
      }
    }
    // ds into dp
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = qr + (e >> 1) * 8, key = key0 + j * 8 + 2 * tq + (e & 1);
        const bool in = ok_s[ri] && visible(p, key, kv_end, qpos_s[ri]);
        const float pr = in ? expf(s[j][e] * p.scale - lse_s[ri]) : 0.f;
        dp[j][e] = pr * (dp[j][e] - delta_s[ri]) * p.scale;
      }
    // dq += bf16(ds) k over the tile's keys
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      const uint32_t as[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int r = kk * 16 + 2 * tq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        mma(dq[n], as, col_pair<LD>(ks, r, n * 8 + gq), col_pair<LD>(ks, r + 8, n * 8 + gq));
    }
  }
  // this thread's rows qr and qr + 8, columns 8 n + 2 tq and + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + qr + 8 * half;
    if (r >= rows_all) continue;
    bf16* dst = p.dq + row_at(r) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(dq[n][2 * half], dq[n][2 * half + 1]);
  }
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  using D = Dims<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_kv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D::kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_q_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, D::q_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((p.Skv + kKeyTile - 1) / kKeyTile, p.Hkv, p.B);
  flash_attention_bwd_kv_kernel<HD><<<kv_grid, kThreads, D::kv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((p.Sq * p.rep + kRowTile - 1) / kRowTile, p.Hkv, p.B);
  flash_attention_bwd_q_kernel<HD><<<q_grid, kThreads, D::q_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launches (0 = launched): the delta kernel,
// then dK/dV, then dQ, on `stream`.  delta is a (B, Hp, Sq) float32
// workspace.  cudaErrorInvalidValue for a head_dim the kernels are not built
// for (a multiple of 16 up to 128) or heads that do not group.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const void* lse, void* delta, const void* q_pos,
                               const void* kv_valid, void* dq, void* dk, void* dv, int B, int Sq,
                               int Skv, int Hp, int Hkv, int hd, int causal, int window,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hp % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hp = Hp;
  p.Hkv = Hkv;
  p.rep = Hp / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / std::sqrt((double)hd));
  const int rows_all = B * Sq * Hp;
  flash_attention_bwd_delta_kernel<<<(rows_all + kDeltaWarps - 1) / kDeltaWarps,
                                     kDeltaWarps * 32, 0, s>>>(
      static_cast<const bf16*>(out), p.dout, static_cast<float*>(delta), rows_all, Sq, Hp, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define BWD_CASE(HD) \
  case HD:           \
    return launch<HD>(p, s);
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
