// Mamba2's chunked SSD scan (state-space duality), for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd, _kernel).  Within a chunk of Q tokens, with cum the inclusive cumsum
// of da:
//   y_i   = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) xdt_j      (intra)
//         + exp(cum_i) (c_i . state before the chunk)              (inter)
//   state = state exp(cum_Q) + sum_j exp(cum_Q - cum_j) b_j (x) xdt_j
//
// Layouts, all float32 and contiguous:
//   xdt (B, L, H, P)   da (B, L, H)   b, c (B, L, G, N)   h0 (B, H, N, P)
//   y   (B, L, H, P)   h_final (B, H, N, P)
// Head h reads group h / (H / G) of b and c (the contiguous block mapping
// of the model's groups-to-heads expansion; G = H is one group a head).
// L is a multiple of Q (the wrapper pads with da = 0 and zero inputs); N and
// P are multiples of 4, P <= 128, and N / 16 times P / 32 (both rounded
// up, the latter to 1, 2 or 4) at most 16; any Q.  Workspaces, allocated by
// the wrapper: cum (B, H, L), states (B, L / Q, H, N, P) and b_tf32 (B,
// L / Q, H).
//
// What bounds it on this card: operations.  At Mamba2-1.3B's prefill shape
// (Q 256, N 128, P 64) a chunk needs ~21 MFLOP of products (the causal half
// of its two Q x Q products and its two Q x N x P products) for ~0.15 MB of
// inputs and outputs once b and c are read per group.  The function is
// float32, and one TF32 tensor-core product keeps ~3 decimal digits, too
// few for the kernel's 1e-4 check (ssd_precision_study.py measures a
// single-TF32 form at up to 7e-4); so every product is 3xTF32: each operand
// x splits into hi (x cut to TF32) and lo = x - hi, and the tensor cores sum
// lo.hi + hi.lo + hi.hi in float32 (the lo.lo term, ~2^-20 relative, is
// dropped).  Three products at 495 TFLOP/s are still 2.5x the 67 TFLOP/s of
// the float32 CUDA cores.  Bytes come next: xdt in and y out are most of
// them, plus a float32 state workspace written once and read twice.
//
// What the design does about it:
// - The chunks run in parallel, in three kernels of one call (the public
//   layout of Mamba2's own Triton kernels: chunk state, state passing,
//   chunk scan):
//   (a) ssd_chunk_state_kernel, one block per (batch, chunk, head): the
//       chunk's cumsum (kept in `cum` for (b) and (c)) and its state
//       sum_j exp(cum_Q - cum_j) b_j (x) xdt_j, on the tensor cores, into
//       `states`; token tiles stream through two cp.async stages.
//   (b) ssd_state_pass_kernel, per (batch, head, slice of N x P): the
//       sequential walk over chunks, in place: each chunk's state becomes
//       the state before it; the last is h_final.
//   (c) ssd_output_kernel, one block per (batch, chunk, head, 64-row tile):
//       the inter part from the state before the chunk, then the intra part
//       over the column tiles j0 <= i0.  Tiles above the diagonal are never
//       computed, and on the diagonal tile every 8-column block above a
//       16-row strip is skipped: the masked half costs no operations, and
//       its exponent cum_i - cum_j, positive and large with realistic da, is
//       never evaluated.
//   Blocks of one (batch, chunk) run head after head, so the heads of a
//   group find their b and c tiles in L2; b and c are read per group.
// - Every product is mma.sync m16n8k8 TF32 (no wgmma: TF32 wgmma takes both
//   operands K-major from shared memory, and the token-contracted products
//   would need transposed tiles).  Shared tiles keep their global row
//   layout; row strides are 4 mod 32 words where a fragment reads along the
//   contraction (ldmatrix for the c and b tiles of (c)) and 8 mod 32 where
//   it reads across it, so fragment loads hit 32 distinct banks.  The three
//   passes of a 3xTF32 product run across 2-4 accumulators, so that no
//   product waits on the one before it.
// - What costs most beside the products is splitting operands: the split
//   is an AND and a subtraction, where cvt.rna.tf32.f32 takes four
//   instructions on this card; B fragments are split once and serve every
//   row tile a warp holds.
// - The scores stay in registers between their two products: the m16n8
//   accumulator holds columns 2t, 2t+1 of thread group t, and the TF32 A
//   fragment wants columns t, t+4, so scores.xdt contracts over the
//   permuted order (t -> 2t, t+4 -> 2t+1) and reads xdt's rows in that
//   order.  The decay and the causal mask are applied to the accumulator
//   before it splits into hi and lo.
// - In (c) the 8 warps are 4 row strips of 16 by 2 halves: the halves split
//   the inter product over N and the scores over the tile's columns, and
//   their partial y meet in shared memory at the end.  The state tile
//   shares shared memory with the column tiles, which it precedes (85.5 KB
//   at Mamba2's widths: two blocks an SM; 52.7 KB at Zamba2's: three).  The
//   b and xdt tiles are two cp.async groups: each lands under the other's
//   product.
// - In (a), where the state has few 16 x 32 pieces (Zamba2's N 64), the
//   warps split the tokens in two groups so that each warp holds two row
//   tiles; the groups' partial states meet in shared memory.
// - The models' b and c are bf16 values, exact in TF32: their lo parts are
//   zero and the passes that multiply them add exact zeros.  (a) notes
//   whether a chunk's b is TF32-valued (from the bits it reads anyway) in
//   `b_tf32`; (c) checks its c tile once.  Where both are, the scores are
//   one TF32 product (the same sums as three, less the zeros) and c.state
//   two; else every product is 3xTF32.  Drawn float32 inputs take the
//   3xTF32 path throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // token tile: rows i and columns j of a chunk
constexpr int kThreads = 256;     // 8 warps, in (a) and (c)
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 128;
constexpr int kMaxPieces = 2;     // 16-row tiles of a chunk's state a warp in (a)
constexpr int kPassBatch = 8;     // chunk states (b) loads ahead
constexpr size_t kMaxSmemPerSM = 233472;  // 228 KB of an SM's shared memory for blocks

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row stride (words) of a tile whose fragments read along its rows: 4 mod 32.
__host__ __device__ constexpr int ld_along(int w) { return round_up(w, 32) + 4; }
// Row stride of a tile whose fragments read down its columns: 8 mod 32.
__host__ __device__ constexpr int ld_across(int w) { return round_up(w, 32) + 8; }
// The output kernel's tiles of 8 p columns: P / 8 rounded up to 1, 2, 4, 8
// or 16 (the kernel's instantiations); the tiles past P are zero.
__host__ __device__ constexpr int p_tiles(int P) {
  return P <= 8 ? 1 : P <= 16 ? 2 : P <= 32 ? 4 : P <= 64 ? 8 : 16;
}

// hi = x cut to TF32 (its top 10 mantissa bits), lo = x - hi (exact in
// float32, below 2^-10 |x|; the tensor core reads lo's top 10 mantissa
// bits, so lo carries x to ~2^-20).  Two instructions: cvt.rna.tf32.f32
// takes four on this card (a finiteness test and a select around the
// rounding add).  A finite x only: an infinity's lo is NaN.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment of m16n8k8 (a0 row g col t, a1 row g+8 col t, a2 row g
// col t+4, a3 row g+8 col t+4), split.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(FragA& a, float a0, float a1, float a2, float a3) {
  split(a0, a.hi[0], a.lo[0]);
  split(a1, a.hi[1], a.lo[1]);
  split(a2, a.hi[2], a.lo[2]);
  split(a3, a.hi[3], a.lo[3]);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kN B fragments of m16n8k8 (b0 row t, b1 row t + 4, column g), split.
template <int kN>
struct FragB {
  uint32_t hi[kN][2], lo[kN][2];
};

template <int kN>
__device__ __forceinline__ void split_b(FragB<kN>& b, int s, float b0, float b1) {
  split(b0, b.hi[s][0], b.lo[s][0]);
  split(b1, b.hi[s][1], b.lo[s][1]);
}

// d[s] += a . b_s in 3xTF32 for s < kN <= kM: the three passes (lo.hi,
// hi.lo, hi.hi) run across the kN accumulators, so that no product waits
// on the one before it.  kAExact: a is a TF32 value (a.lo is zero and its
// pass, which would add exact zeros, is left out).
template <int kN, bool kAExact = false, int kM = kN>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragB<kM>& b) {
  static_assert(kN <= kM, "fragments for every accumulator");
  if constexpr (!kAExact) {
#pragma unroll
    for (int s = 0; s < kN; ++s) mma(d[s], a.lo, b.hi[s][0], b.hi[s][1]);
  }
#pragma unroll
  for (int s = 0; s < kN; ++s) mma(d[s], a.hi, b.lo[s][0], b.lo[s][1]);
#pragma unroll
  for (int s = 0; s < kN; ++s) mma(d[s], a.hi, b.hi[s][0], b.hi[s][1]);
}

// The same with b_s at b0[s * step] (row t) and b1[s * step] (row t + 4).
template <int kN, bool kAExact = false>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const float* b0,
                                     const float* b1, int step) {
  FragB<kN> b;
#pragma unroll
  for (int s = 0; s < kN; ++s) split_b(b, s, b0[s * step], b1[s * step]);
  mma3<kN, kAExact>(d, a, b);
}

// ldmatrix.x4 of 32-bit words: lanes 8m .. 8m + 7 give the row addresses of
// 8 x 4-word matrix m; r[m] is word lane % 4 of its row lane / 4.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragment of a row-major tile, by ldmatrix: p is this lane's row
// address, tile + (r0 + lane % 8 + 8 (lane / 8 % 2)) ld + 4 (lane / 16) + k0.
__device__ __forceinline__ void ldsm_a(FragA& a, const float* p) {
  uint32_t r[4];
  ldsm4(r, p);
  split_a(a, __uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
          __uint_as_float(r[3]));
}

// B fragments s0, s0 + 1 of a tile stored [n][k] (k contiguous), by
// ldmatrix: p is tile + (n0 + 8 s0 + lane % 8 + 8 (lane / 16)) ld +
// 4 (lane / 8 % 2) + k0.
template <int kN>
__device__ __forceinline__ void ldsm_b2(FragB<kN>& b, int s0, const float* p) {
  uint32_t r[4];
  ldsm4(r, p);
  split_b(b, s0, __uint_as_float(r[0]), __uint_as_float(r[1]));
  split_b(b, s0 + 1, __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// One 16-byte cp.async from global to shared memory; zero-filled when
// !valid (nothing is read then).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies, asynchronously, into dst[r][col] (row stride ld) for r < kT,
// col < wpad row r of src (row stride `stride` floats, `width` of them)
// where r < rows and col < width, else 0.  width and wpad are multiples of
// 4.  Not committed.
__device__ void copy_tile(float* dst, int ld, const float* __restrict__ src, size_t stride,
                          int rows, int width, int wpad) {
  // each thread keeps one 4-column slot and walks rows: one division a call
  const int w4 = wpad / 4, step = blockDim.x / w4;
  const int col = (threadIdx.x % w4) * 4;
  if ((int)threadIdx.x >= step * w4) return;
  for (int r = threadIdx.x / w4; r < kT; r += step) {
    const bool valid = r < rows && col < width;
    cp16(dst + r * ld + col, valid ? src + r * stride + col : src, valid);
  }
}

// Whether every word this thread copied by copy_tile(dst, ld, ..., wpad)
// is a TF32 value (its low 13 mantissa bits zero, as a bf16 value's are;
// the zero fill is).  Call it after the copies landed.
__device__ bool copied_tf32(const float* dst, int ld, int wpad) {
  const int w4 = wpad / 4, step = blockDim.x / w4;
  const int col = (threadIdx.x % w4) * 4;
  uint32_t low = 0;
  if ((int)threadIdx.x < step * w4)
    for (int r = threadIdx.x / w4; r < kT; r += step) {
      const uint4 v = *reinterpret_cast<const uint4*>(dst + r * ld + col);
      low |= v.x | v.y | v.z | v.w;
    }
  return (low & 0x1fffu) == 0;
}

// Warp 0: cum[t] = da[t0] + ... + da[t0 + t] for t < Q (token t of the
// chunk at da[row0 + t * H]); cum[Q .. qpad) repeat cum[Q - 1].
__device__ void chunk_cumsum(float* cum, const float* __restrict__ da, size_t row0, int H,
                             int Q, int qpad) {
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int s = min(lane * per, Q), e = min(s + per, Q);
  float run = 0.f;
  for (int t = s; t < e; ++t) {
    run += da[row0 + (size_t)t * H];
    cum[t] = run;
  }
  float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float before = incl - run;
  for (int t = s; t < e; ++t) cum[t] += before;
  __syncwarp();
  const float last = cum[Q - 1];
  for (int t = Q + lane; t < qpad; t += 32) cum[t] = last;
}

// ---------------------------------------------------------------- (a)

// The chunk-state kernel's p columns: 32, 64 or 128 (1, 2 or 4 pieces of
// 32, so that each warp keeps one piece); the columns past P are zero.
__host__ __device__ constexpr int state_pw(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// Two stages of a token tile's b and xdt, then the chunk's cumsum.
__host__ __device__ size_t state_stage_floats(int N, int P) {
  return (size_t)kT * ld_across(round_up(N, 16)) + (size_t)kT * ld_across(state_pw(P));
}

__host__ __device__ size_t state_smem_floats(int N, int P, int Q) {
  return 2 * state_stage_floats(N, P) + 2 * round_up(Q, kT);
}

// The chunk-state kernel's split of the tokens over warps: ks groups of
// warps each sum every ks-th k-step.  Where the state has few 16 x 32
// pieces, splitting lets a warp hold two row tiles (one B fragment then
// serves both); a warp of a split group holds at most two, and a group
// holds every 32-column piece.
__host__ __device__ constexpr int state_ksplit(int N, int P) {
  const int units = (round_up(N, 16) / 16) * (state_pw(P) / 32);
  const int ks = units > 8 ? 1 : units > 4 ? 2 : 4;
  const int most = kWarps / (state_pw(P) / 32);
  return ks < most ? ks : most;
}

// states[b, c, h] = sum_j exp(cum_Q - cum_j) b_j (x) xdt_j over chunk c,
// as an (N x tokens) . (tokens x P) product: A[n][j] = w_j b[j][n] read
// down the b tile's columns, B[j][p] = xdt[j][p].  The warps form
// state_ksplit groups over the k-steps; in a group of W warps, warp w owns
// 32 columns, piece w % pieces, and the 16-row tiles w / pieces, + W /
// pieces, ..., so its B fragments serve every row tile it owns; the groups'
// partial states meet in shared memory at the end.  The token tiles
// stream through two stages: the next tile's copies run under this tile's
// products.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const float* __restrict__ xdt, const float* __restrict__ da,
                       const float* __restrict__ bg, float* __restrict__ cum_out,
                       float* __restrict__ states, int* __restrict__ b_tf32, int L, int H,
                       int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int nm = round_up(N, 16), pp = state_pw(P);
  const int ldb = ld_across(nm), ldx = ld_across(pp), qpad = round_up(Q, kT);
  const int stage = (int)state_stage_floats(N, P);
  float* cum = smem + 2 * stage;  // [qpad]
  float* w = cum + qpad;          // [qpad]  exp(cum_Q - cum_j)

  const int nc = L / Q, ntiles = (Q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc, b = idx / nc;
  const int grp = h / (H / G);
  const size_t tok0 = (size_t)b * L + (size_t)c * Q;

  // stage s: b tile [kT][ldb], then xdt tile [kT][ldx]
  auto fetch = [&](int jt) {
    float* bs = smem + (jt & 1) * stage;
    const int j0 = jt * kT, rows = min(kT, Q - j0);
    copy_tile(bs, ldb, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, rows, N, nm);
    copy_tile(bs + kT * ldb, ldx, xdt + ((tok0 + j0) * H + h) * P, (size_t)H * P, rows, P, pp);
    cp_commit();
  };
  fetch(0);
  if (threadIdx.x < 32) {
    chunk_cumsum(cum, da, tok0 * H + h, H, Q, qpad);
    __syncwarp();
    const float last = cum[Q - 1];  // past Q: exp(0) against zero rows
    for (int k = threadIdx.x; k < qpad; k += 32) w[k] = expf(last - cum[k]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ppieces = pp / 32, ks = state_ksplit(N, P), wpg = kWarps / ks;
  const int kpart = warp / wpg, wk = warp % wpg, mstep = wpg / ppieces;
  const int p0 = 32 * (wk % ppieces), mt0 = wk / ppieces;
  float acc[kMaxPieces][4][4];
#pragma unroll
  for (int r = 0; r < kMaxPieces; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][s][e] = 0.f;

  // the low 13 bits of every b value this thread reads (the warps' A
  // fragments cover the tile between them): zero when b is TF32-valued
  uint32_t low = 0;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) {
      fetch(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile jt (and on the first pass the cumsum) is in
    if (jt == 0) {
      float* cum_row = cum_out + ((size_t)b * H + h) * L + (size_t)c * Q;
      for (int k = threadIdx.x; k < Q; k += kThreads) cum_row[k] = cum[k];
    }
    const float* bs = smem + (jt & 1) * stage;
    const float* xs = bs + kT * ldb;
    const int j0 = jt * kT, rows = min(kT, Q - j0);
    for (int k0 = 8 * kpart; k0 < rows; k0 += 8 * ks) {
      const float w0 = w[j0 + k0 + t], w1 = w[j0 + k0 + t + 4];
      const float* b0 = bs + (k0 + t) * ldb + g;
      const float* b1 = b0 + 4 * ldb;
      const float* x0 = xs + (k0 + t) * ldx + p0 + g;
      FragB<4> bx;
#pragma unroll
      for (int s = 0; s < 4; ++s) split_b(bx, s, x0[8 * s], x0[4 * ldx + 8 * s]);
#pragma unroll
      for (int r = 0; r < kMaxPieces; ++r) {
        const int m0 = 16 * (mt0 + r * mstep);
        if (m0 < nm) {
          const float v0 = b0[m0], v1 = b0[m0 + 8], v2 = b1[m0], v3 = b1[m0 + 8];
          low |= __float_as_uint(v0) | __float_as_uint(v1) | __float_as_uint(v2) |
                 __float_as_uint(v3);
          FragA a;
          split_a(a, w0 * v0, w0 * v1, w1 * v2, w1 * v3);
          mma3<4>(acc[r], a, bx);
        }
      }
    }
    __syncthreads();  // stage jt & 1 is read: tile jt + 2 may land there
  }

  // whether the chunk's b is TF32-valued, for the output kernel
  const int tf32 = __syncthreads_and((low & 0x1fffu) == 0);
  if (threadIdx.x == 0) b_tf32[((size_t)b * nc + c) * H + h] = tf32;

  if (ks > 1) {  // the loop ended on a barrier: the stages are free
    // groups 1 .. ks - 1 leave their partial state, [slot][register][lane]
    if (kpart > 0) {
      float* part = smem + (size_t)((kpart - 1) * wpg + wk) * 32 * 32 + lane;
#pragma unroll
      for (int r = 0; r < kMaxPieces; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[((r * 4 + s) * 4 + e) * 32] = acc[r][s][e];
    }
    __syncthreads();
    if (kpart > 0) return;
    for (int k = 1; k < ks; ++k)
#pragma unroll
      for (int r = 0; r < kMaxPieces; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][s][e] += smem[(size_t)((k - 1) * wpg + wk) * 32 * 32 +
                                 ((r * 4 + s) * 4 + e) * 32 + lane];
  }

  float* out = states + (((size_t)b * nc + c) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < kMaxPieces; ++r) {
    const int m0 = 16 * (mt0 + r * mstep);
    if (m0 >= nm) break;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = p0 + 8 * s + 2 * t;  // P is even: p < P means p + 1 < P
      if (p >= P) continue;
      if (m0 + g < N)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + g) * P + p) =
            make_float2(acc[r][s][0], acc[r][s][1]);
      if (m0 + g + 8 < N)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + g + 8) * P + p) =
            make_float2(acc[r][s][2], acc[r][s][3]);
    }
  }
}

// ---------------------------------------------------------------- (b)

// For one (batch, head) and four consecutive elements of the N x P state:
// states[c] becomes the state before chunk c (h0 before chunk 0); h_final
// the state after the last.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ h0, const float* __restrict__ cum,
                      float* __restrict__ states, float* __restrict__ hout, int L, int H,
                      int NP, int Q) {
  const int nc = L / Q;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  float4 s = *reinterpret_cast<const float4*>(h0 + (size_t)bh * NP + e);
  const float* last = cum + (size_t)bh * L + Q - 1;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 v[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        v[k] = *reinterpret_cast<const float4*>(
            states + (((size_t)b * nc + c0 + k) * H + h) * NP + e);
        d[k] = expf(last[(size_t)(c0 + k) * Q]);
      }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(states + (((size_t)b * nc + c0 + k) * H + h) * NP + e) = s;
        s = make_float4(fmaf(s.x, d[k], v[k].x), fmaf(s.y, d[k], v[k].y),
                        fmaf(s.z, d[k], v[k].z), fmaf(s.w, d[k], v[k].w));
      }
  }
  *reinterpret_cast<float4*>(hout + (size_t)bh * NP + e) = s;
}

// ---------------------------------------------------------------- (c)

// Shared memory of (c) before its two rows of cumsums: the c tile and,
// over the same words, first the state tile, then the b and xdt tiles,
// last the two halves' partial y.
__host__ __device__ size_t output_body_floats(int N, int P) {
  const int np = round_up(N, 8), pp = 8 * p_tiles(P);
  const size_t c_tile = (size_t)kT * ld_along(np);
  const size_t tiles = c_tile + (size_t)kT * ld_along(np) + (size_t)kT * ld_along(pp);
  const size_t state = c_tile + (size_t)np * ld_across(pp);
  const size_t halves = (size_t)2 * kT * ld_along(pp);
  return tiles > state ? (tiles > halves ? tiles : halves) : (state > halves ? state : halves);
}

__host__ __device__ size_t output_smem_floats(int N, int P) {
  return output_body_floats(N, P) + 2 * kT;
}

// sc[s] = c_i . b_j for this warp's kS 8-column blocks of the column tile,
// over N; a_lane and b_lane are this lane's ldmatrix rows (ssd_output_kernel).
// kExact: both tiles hold TF32 values (bf16 ones, as the model's b and c
// are), so one product is the float32 one: lo parts are zero and their
// products would add exact zeros.
template <int kS, bool kExact>
__device__ __forceinline__ void scores(float (*sc)[4], const float* a_lane,
                                       const float* b_lane, int ldc, int np) {
#pragma unroll
  for (int s = 0; s < kS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[s][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < np; k0 += 8) {
    if constexpr (kExact) {
      uint32_t a[4], b[4];
      ldsm4(a, a_lane + k0);
      ldsm4(b, b_lane + k0);
      mma(sc[0], a, b[0], b[1]);
      mma(sc[1], a, b[2], b[3]);
      if constexpr (kS == 4) {
        ldsm4(b, b_lane + 16 * ldc + k0);
        mma(sc[2], a, b[0], b[1]);
        mma(sc[3], a, b[2], b[3]);
      }
    } else {
      FragA a;
      ldsm_a(a, a_lane + k0);
      FragB<kS> b;
      ldsm_b2(b, 0, b_lane + k0);
      if constexpr (kS == 4) ldsm_b2(b, 2, b_lane + 16 * ldc + k0);
      mma3<kS>(sc, a, b);
    }
  }
}

// acc += c_i . state over this half's k-steps of N (every other 8, from
// 8 hf); s_lane is the state tile at row t, column g.  kAExact: the c tile
// holds TF32 values, whose lo pass is left out.
template <int kPT, bool kAExact>
__device__ __forceinline__ void inter(float (*acc)[4], const float* a_lane, const float* s_lane,
                                      int lds, int np, int hf) {
#pragma unroll 2
  for (int k0 = 8 * hf; k0 < np; k0 += 16) {
    FragA a;
    if constexpr (kAExact)
      ldsm4(a.hi, a_lane + k0);
    else
      ldsm_a(a, a_lane + k0);
    const float* s0 = s_lane + k0 * lds;
    constexpr int kQ = kPT < 4 ? kPT : 4;
#pragma unroll
    for (int q = 0; q < kPT; q += kQ)
      mma3<kQ, kAExact>(acc + q, a, s0 + 8 * q, s0 + 4 * lds + 8 * q, 8);
  }
}

// acc += sc . xdt over this warp's kS blocks of 8 columns j: block s is one
// k-step whose index t stands for column 2t and t + 4 for 2t + 1, so the
// accumulator's registers are the A fragment as they are; x_lane is
// xdt tile row (32 half + 2t), column g.
template <int kS, int kPT>
__device__ __forceinline__ void scores_times_x(float (*acc)[4], const float (*sc)[4],
                                               const float* x_lane, int ldx) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    FragA a;
    split_a(a, sc[s][0], sc[s][2], sc[s][1], sc[s][3]);
    const float* x0 = x_lane + 8 * s * ldx;
    // four p tiles at a time: their split B fragments take 16 registers
    constexpr int kQ = kPT < 4 ? kPT : 4;
#pragma unroll
    for (int q = 0; q < kPT; q += kQ) mma3<kQ>(acc + q, a, x0 + 8 * q, x0 + ldx + 8 * q, 8);
  }
}

// y of one 64-row tile of a chunk.  Warp w: rows 16 (w % 4) .. + 16, half
// w / 4.  acc holds the warp's partial y over every p column (kPT =
// p_tiles(P) tiles of 8).
template <int kPT, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
ssd_output_kernel(const float* __restrict__ xdt, const float* __restrict__ bg,
                  const float* __restrict__ cg, const float* __restrict__ cum,
                  const float* __restrict__ states, const int* __restrict__ b_tf32,
                  float* __restrict__ y, int L, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int np = round_up(N, 8), pp = 8 * kPT;
  const int ldc = ld_along(np), ldx = ld_along(pp), lds = ld_across(pp);
  float* cs = smem;             // [kT][ldc]  c of the row tile
  float* bs = cs + kT * ldc;    // [kT][ldc]  b of the column tile
  float* xs = bs + kT * ldc;    // [kT][ldx]  xdt of the column tile
  float* st = bs;               // [np][lds]  the state before the chunk
  float* red = smem;            // [2][kT][ldx] the halves' partial y
  float* cum_i = smem + output_body_floats(N, P);  // [kT]
  float* cum_j = cum_i + kT;                        // [kT]

  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int it = nt - 1 - idx % nt;  // the longest row tile of a head first
  idx /= nt;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc, b = idx / nc;
  const int grp = h / (H / G);
  const int i0 = it * kT, rows = min(kT, Q - i0);
  const size_t tok0 = (size_t)b * L + (size_t)c * Q;
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;

  copy_tile(cs, ldc, cg + ((tok0 + i0) * G + grp) * N, (size_t)G * N, rows, N, np);
  {
    const float* src = states + (((size_t)b * nc + c) * H + h) * N * P;
    const int w4 = pp / 4, step = kThreads / w4, p = (threadIdx.x % w4) * 4;
    if ((int)threadIdx.x < step * w4)
      for (int n = threadIdx.x / w4; n < np; n += step) {
        const bool valid = n < N && p < P;
        cp16(st + n * lds + p, valid ? src + (size_t)n * P + p : src, valid);
      }
  }
  cp_commit();
  for (int i = threadIdx.x; i < kT; i += kThreads) cum_i[i] = crow[min(i0 + i, Q - 1)];
  cp_wait<0>();
  const bool c_exact = __syncthreads_and(copied_tf32(cs, ldc, np));
  // c's row tile and the chunk's b (as the chunk-state kernel found it)
  const bool exact = c_exact && b_tf32[((size_t)b * nc + c) * H + h];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), hf = warp >> 2;
  float acc[kPT][4];
#pragma unroll
  for (int q = 0; q < kPT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  // this lane's ldmatrix rows: of the c tile (A) and of the b tile (B)
  const float* a_lane = cs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldc + 4 * (lane >> 4);
  const float* b_lane = bs + (32 * hf + (lane & 7) + 8 * (lane >> 4)) * ldc + 4 * ((lane >> 3) & 1);

  // inter: acc = c_i . state over this half's k-steps of N, times exp(cum_i)
  if (c_exact)
    inter<kPT, true>(acc, a_lane, st + t * lds + g, lds, np, hf);
  else
    inter<kPT, false>(acc, a_lane, st + t * lds + g, lds, np, hf);
  const int ia = r0 + g, ib = ia + 8;
  const float ca = cum_i[ia], cb = cum_i[ib];
  {
    const float ea = expf(ca), eb = expf(cb);
#pragma unroll
    for (int q = 0; q < kPT; ++q) {
      acc[q][0] *= ea;
      acc[q][1] *= ea;
      acc[q][2] *= eb;
      acc[q][3] *= eb;
    }
  }

  // intra: for each column tile j0 <= i0, scores of this half's 32 columns,
  // decayed and masked in registers, then acc += scores . xdt.  The b tile
  // and the xdt tile are two copy groups: xdt lands under the scores, the
  // next b tile under scores . xdt, the next xdt under the next scores.
  const int jw = 32 * hf;
  auto fetch_b = [&](int jt) {
    const int j0 = jt * kT;
    copy_tile(bs, ldc, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, min(kT, Q - j0), N, np);
    cp_commit();
  };
  auto fetch_x = [&](int jt) {
    const int j0 = jt * kT;
    copy_tile(xs, ldx, xdt + ((tok0 + j0) * H + h) * P, (size_t)H * P, min(kT, Q - j0), P, pp);
    cp_commit();
  };
  __syncthreads();  // the state (under the b tile) is read
  fetch_b(0);
  fetch_x(0);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    for (int j = threadIdx.x; j < kT; j += kThreads) cum_j[j] = crow[min(j0 + j, Q - 1)];
    cp_wait<1>();
    __syncthreads();  // b tile jt and cum_j are in
    const bool diag = jt == it;
    // 8-column blocks s of this half with a column j <= some row of the
    // strip (on the diagonal tile: jw + 8 s <= r0 + 15): 0, 2 or 4
    int live = 4;
    if (diag) live = r0 + 15 < jw ? 0 : min(4, (r0 + 15 - jw) / 8 + 1);
    float sc[4][4];
    if (live == 4 && exact)
      scores<4, true>(sc, a_lane, b_lane, ldc, np);
    else if (live == 4)
      scores<4, false>(sc, a_lane, b_lane, ldc, np);
    else if (live == 2 && exact)
      scores<2, true>(sc, a_lane, b_lane, ldc, np);
    else if (live == 2)
      scores<2, false>(sc, a_lane, b_lane, ldc, np);
    cp_wait<0>();
    __syncthreads();  // xdt tile jt is in; every warp is done with the b tile
    if (jt < it) fetch_b(jt + 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s >= live) continue;
      const int j = jw + 8 * s + 2 * t;
      const float c0 = cum_j[j], c1 = cum_j[j + 1];
      // a masked entry's exponent is replaced by 0 before exp, so even a
      // select that evaluates both sides never forms it.  __expf (ex2.approx
      // of x log2 e): for the decays that matter (x > -20) it is within
      // ~1e-6 of expf, far inside the kernel's 1e-4 check, at 2 of expf's
      // ~10 instructions, 16 times a tile a lane.
      const bool k0 = !diag || j <= ia, k1 = !diag || j + 1 <= ia;
      const bool k2 = !diag || j <= ib, k3 = !diag || j + 1 <= ib;
      sc[s][0] = k0 ? sc[s][0] * __expf(k0 ? ca - c0 : 0.f) : 0.f;
      sc[s][1] = k1 ? sc[s][1] * __expf(k1 ? ca - c1 : 0.f) : 0.f;
      sc[s][2] = k2 ? sc[s][2] * __expf(k2 ? cb - c0 : 0.f) : 0.f;
      sc[s][3] = k3 ? sc[s][3] * __expf(k3 ? cb - c1 : 0.f) : 0.f;
    }
    const float* x_lane = xs + (jw + 2 * t) * ldx + g;
    if (live == 4)
      scores_times_x<4, kPT>(acc, sc, x_lane, ldx);
    else if (live == 2)
      scores_times_x<2, kPT>(acc, sc, x_lane, ldx);
    __syncthreads();  // every warp is done with the xdt tile and cum_j
    if (jt < it) fetch_x(jt + 1);
  }

  // every tile is read (the loop ends on a barrier): the words take the
  // partial y
  float* part = red + hf * kT * ldx;
#pragma unroll
  for (int q = 0; q < kPT; ++q) {
    const int p = 8 * q + 2 * t;
    *reinterpret_cast<float2*>(part + ia * ldx + p) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(part + ib * ldx + p) = make_float2(acc[q][2], acc[q][3]);
  }
  __syncthreads();
  const int p4 = P / 4;
  for (int e = threadIdx.x; e < rows * p4; e += kThreads) {
    const int i = e / p4, p = (e % p4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(red + i * ldx + p);
    const float4 v = *reinterpret_cast<const float4*>(red + (kT + i) * ldx + p);
    *reinterpret_cast<float4*>(y + ((tok0 + i0 + i) * H + h) * P + p) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
}

// Three blocks an SM where their shared memory allows (N <= 64 at P 64)
// and their registers fit without spilling much (P <= 64), else two.
template <int kPT>
cudaError_t launch_output(const float* xdt, const float* b, const float* c, const float* cum,
                          const float* states, const int* b_tf32, float* y, int B, int L, int H,
                          int G, int P, int N, int Q, size_t smem, cudaStream_t stream) {
  auto kernel = kPT <= 8 && 3 * smem <= kMaxSmemPerSM ? ssd_output_kernel<kPT, 3>
                                                       : ssd_output_kernel<kPT, 2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * (L / Q) * H * ((Q + kT - 1) / kT);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(xdt, b, c, cum, states, b_tf32, y, L,
                                                       H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block, in bytes: which 0 the chunk-state
// kernel, 1 the output kernel.
long long ssd_smem_bytes(int which, int N, int P, int Q) {
  const size_t f = which == 0 ? state_smem_floats(N, P, Q) : output_smem_floats(N, P);
  return (long long)(f * sizeof(float));
}

// The three kernels on `stream`; returns the CUDA error of the first launch
// that failed (0 = all launched).  cum (B, H, L) and states (B, L / Q, H,
// N, P) are float32 workspaces, b_tf32 (B, L / Q, H) an int32 one.
int ssd_launch(const void* xdt, const void* da, const void* b, const void* c,
               const void* h0, void* y, void* hout, void* cum, void* states, void* b_tf32,
               int B, int L, int H, int G, int P, int N, int Q, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* bg = static_cast<const float*>(b);
  const float* cg = static_cast<const float*>(c);
  float* cw = static_cast<float*>(cum);
  float* sw = static_cast<float*>(states);
  int* fw = static_cast<int*>(b_tf32);
  const int nc = L / Q;

  const size_t smem_a = state_smem_floats(N, P, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<<<(unsigned)((long long)B * nc * H), kThreads, smem_a, st>>>(
      x, static_cast<const float*>(da), bg, cw, sw, fw, L, H, G, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int np4 = N * P / 4;
  ssd_state_pass_kernel<<<dim3((np4 + kPassThreads - 1) / kPassThreads, B * H), kPassThreads,
                          0, st>>>(static_cast<const float*>(h0), cw, sw,
                                   static_cast<float*>(hout), L, H, N * P, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_c = output_smem_floats(N, P) * sizeof(float);
  float* yo = static_cast<float*>(y);
  switch (p_tiles(P)) {
    case 1: return (int)launch_output<1>(x, bg, cg, cw, sw, fw, yo, B, L, H, G, P, N, Q, smem_c, st);
    case 2: return (int)launch_output<2>(x, bg, cg, cw, sw, fw, yo, B, L, H, G, P, N, Q, smem_c, st);
    case 4: return (int)launch_output<4>(x, bg, cg, cw, sw, fw, yo, B, L, H, G, P, N, Q, smem_c, st);
    case 8: return (int)launch_output<8>(x, bg, cg, cw, sw, fw, yo, B, L, H, G, P, N, Q, smem_c, st);
    default:
      return (int)launch_output<16>(x, bg, cg, cw, sw, fw, yo, B, L, H, G, P, N, Q, smem_c, st);
  }
}

}  // extern "C"
