// The backward of Mamba2's chunked SSD scan (csrc/ssd.cu), for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference has no SSD backward kernel; its
// gradient is JAX's autodiff of the chunked body (src/repro/models/ssm.py
// ssd_scan, _ssd_scan_body under jax.checkpoint).  This is that gradient in
// closed form (kernels/ssd/ref.py ssd_bwd_ref).  Within a chunk of Q tokens,
// with cum the forward's in-chunk inclusive cumsum of da, L_ij =
// exp(cum_i - cum_j) (i >= j), w_j = exp(cum_Q - cum_j), h_c the state
// before chunk c (the forward's `states`) and G_c = dLoss/dh_c:
//   G_c    = sum_i exp(cum_i) c_i (x) dy_i + exp(cum_Q) G_{c+1}    (G_nc = dh_final, dh0 = G_0)
//   dxdt_j = sum_{i>=j} (c_i.b_j) L_ij dy_i + w_j b_j^T G_{c+1}
//   db_j   = sum_{i>=j} L_ij (dy_i.xdt_j) c_i + w_j G_{c+1} xdt_j
//   dc_i   = sum_{j<=i} L_ij (dy_i.xdt_j) b_j + exp(cum_i) h_c dy_i
//   dda    = the in-chunk reverse cumsum of dcum, where dcum_i is the row
//            sum less the column sum of M_ij = (c_i.b_j) L_ij (dy_i.xdt_j)
//            off its diagonal (the diagonal cancels and is left out of
//            both), plus c_i . (dc_i's inter part), less xdt_i . (dxdt_i's
//            w part), plus at the chunk's last token D_c = <G_{c+1}, h_{c+1}>
//            (h_nc = h_final).
// db and dc are summed over the heads of each group.
//
// Layouts, all float32 and contiguous (L a multiple of Q; N, P multiples of
// 4, at most 128):
//   xdt, dy, dxdt (B, L, H, P)   b, c, db, dc (B, L, G, N)   dda (B, L, H)
//   cum (B, H, L), states (B, L / Q, H, N, P): the forward's workspaces
//   h_final, dh_final, dh0 (B, H, N, P); dh_final may be null (zero)
// Workspaces, allocated by the wrapper: gst (B, L / Q, H, N, P), db_h and
// dc_h (B, L, H, N) per head, rowterm and colterm (B, H, L), dpart (B, L /
// Q, H, slices), and the pair kernel's two: escore (B, L / Q, H, pairs, 64,
// 64), each tile pair's decayed dy.xdt scores, and rowpart (B, L / Q, H,
// tiles, Q), each column tile's part of M's row sums (tiles = Q / 64
// rounded up, pairs = tiles (tiles + 1) / 2).
//
// What bounds it on this card: operations.  Per chunk and head it takes
// five causal products: two Q x Q x N (the scores c.b and db's intra part),
// one more (dc's intra part), two Q x Q x P (dy.xdt and dxdt's intra part),
// and four Q x N x P ones (dxdt's, db's and dc's state terms and the
// reverse pass's input).  Every product runs on the tensor cores in TF32
// passes: an operand x splits into hi (x rounded to TF32) and lo = x - hi,
// and a product sums lo.hi + hi.lo + hi.hi in float32 (lo.lo, ~2^-21
// relative, is dropped).  The models' b and c are bf16 values, exact in
// TF32: their lo is zero, so a product with one of them as an operand takes
// two passes and the scores c.b one; the kernels check the tiles they read
// and take those routes only where the bits allow them, so drawn float32
// inputs keep three passes throughout.  Bytes come next: the score tiles
// the column kernel hands to the row kernel (16 KB a tile pair), and the per-
// head db and dc workspaces, each written once and read once.
//
// What the design does about it:
// - Six kernels a call, all on the current stream:
//   (a) ssd_bwd_chunk_grad_kernel, one block per (batch, chunk, head):
//       sum_i c_i (x) exp(cum_i) dy_i into gst (the forward's chunk-state
//       kernel with c for b and the weights on dy, so that its A operand is
//       c as read); two cp.async stages.
//   (b) ssd_bwd_state_pass_kernel, per (batch, head, slice of N x P): the
//       reverse walk over chunks, in place: gst[c] becomes G_{c+1}; dh0;
//       each warp's part of D_c into dpart (summed in a fixed order later).
//   (c) ssd_bwd_cols_kernel, one block of 16 warps per (batch, chunk,
//       head, 64-token column tile j), walking the row tiles i >= j: the
//       two score tiles
//       b_j.c_i and xdt_j.dy_i of each tile pair are computed here and only
//       here, decayed and masked in registers, and serve every sum: the
//       column side (dxdt_j, db_j of the head, colterm_j) accumulates in
//       registers; the row side gets M's sums down each column (rowpart,
//       per column tile) and the decayed dy.xdt tile itself (escore).
//   (d) ssd_bwd_rows_kernel, one block per (batch, chunk, head, row tile
//       i): dc_i of the head, its inter part from h_c, then escore's tiles
//       of the row times b_j, over j <= i in order; rowterm_i from the inter
//       part and rowpart's sums in column-tile order.
//   (e) ssd_bwd_dda_kernel, a warp per (batch, chunk, head): dcum and its
//       reverse cumsum, plus D_c; ssd_bwd_group_sum_kernel: db and dc
//       summed over each group's heads in head order.
//   Why the row side goes through escore and not through partial dc sums:
//   a tile pair's dc part is 64 x N floats, its score tile 64 x 64, so at
//   N >= 64 the tile is the smaller hand-over, and the row kernel's product
//   then keeps its accumulators in registers over the whole row (no
//   transposition through shared memory, no sum of per-pair partials).  No
//   float atomics: every sum runs in a fixed order, and two runs give the
//   same bits.
// - (c) holds dxdt_j's and db_j's accumulators (P + N columns of 64 rows)
//   through its whole walk, which at 8 warps fills the register file and
//   leaves one block of 8 warps an SM, too few to hide the products'
//   latency.  So it runs 16 warps, 4 row strips of 16 by 2 halves of a row
//   tile's columns by 2 sides of the outputs: a side holds half of dxdt's
//   and half of db's columns.  The two sides of a strip and half are a
//   pair: one computes the scores b_j.c_i, the other xdt_j.dy_i, and they
//   trade the 16 x 32 tiles through shared memory under a barrier of their
//   own, so each score product still runs once.  The halves split the
//   state products over their contraction, and their partial sums meet in
//   shared memory at the end.  In (d) the halves split dc's N columns.  The masked half's
//   exponent, cum_i - cum_j for i < j, positive and large with realistic
//   da, is replaced by 0 before exp and the entry by 0 after, so it is
//   never evaluated.  On the diagonal tile every 8-column block of a half
//   that lies wholly above its 16-row strip is skipped, in (c) and (d), as
//   the forward's output kernel does.
// - Tiles are staged by cp.async into row layouts whose strides make every
//   fragment read conflict-free (4 mod 32 words along the contraction, 8
//   mod 32 across it, as in the forward).  (c) and (d) stream their tiles
//   through two stages: the next tile pair's copies run under this pair's
//   products.
// - The split rounds to nearest, as cvt.rna does: the truncating split of
//   the forward leaves hi below |x| on average and lo of one sign, a bias
//   the lo pass returns only to lo's own TF32 precision.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // token tile: rows and columns of a chunk
constexpr int kThreads = 256;     // 8 warps, in (a), (c) and (d)
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 128;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kMaxPieces = 2;     // 16-row tiles of a chunk's state a warp in (a)
constexpr int kPassBatch = 8;     // chunks (b) loads ahead

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row stride (words) of a tile whose fragments read along its rows: 4 mod 32.
__host__ __device__ constexpr int ld_along(int w) { return round_up(w, 32) + 4; }
// Row stride of a tile whose fragments read down its columns: 8 mod 32.
__host__ __device__ constexpr int ld_across(int w) { return round_up(w, 32) + 8; }
// Tiles of 8 columns (c) and (d) keep of an N or P wide operand: 8 or 16
// (the kernels' instantiations, not both 16); the columns past N or P are
// zero.
__host__ __device__ constexpr int width_tiles(int w) { return w <= 64 ? 8 : 16; }
// Tile pairs (i >= j) of a chunk of nt tiles; pair (i, j) is i (i + 1) / 2 + j.
__host__ __device__ constexpr int pairs_of(int nt) { return nt * (nt + 1) / 2; }

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// hi = x rounded to TF32 to nearest, ties away from zero (cvt.rna's
// rounding: half a TF32 step added to the magnitude's bits, the 13 low
// bits cut; an integer add and an AND, where cvt.rna.tf32.f32 takes four
// instructions on this card), lo = x - hi (exact in float32).  A finite x
// below the largest float's last TF32 step only.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment of m16n8k8 (a0 row g col t, a1 row g+8 col t, a2 row g
// col t+4, a3 row g+8 col t+4): hi and lo, or hi alone for a TF32 value.
struct FragA {
  uint32_t hi[4], lo[4];
};

template <bool kExact>
__device__ __forceinline__ void set_a(FragA& a, float a0, float a1, float a2, float a3) {
  if constexpr (kExact) {
    a.hi[0] = __float_as_uint(a0);
    a.hi[1] = __float_as_uint(a1);
    a.hi[2] = __float_as_uint(a2);
    a.hi[3] = __float_as_uint(a3);
  } else {
    split(a0, a.hi[0], a.lo[0]);
    split(a1, a.hi[1], a.lo[1]);
    split(a2, a.hi[2], a.lo[2]);
    split(a3, a.hi[3], a.lo[3]);
  }
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kN B fragments of m16n8k8 (b0 row t, b1 row t + 4, column g).
template <int kN>
struct FragB {
  uint32_t hi[kN][2], lo[kN][2];
};

template <bool kExact, int kN>
__device__ __forceinline__ void set_b(FragB<kN>& b, int s, float b0, float b1) {
  if constexpr (kExact) {
    b.hi[s][0] = __float_as_uint(b0);
    b.hi[s][1] = __float_as_uint(b1);
  } else {
    split(b0, b.hi[s][0], b.lo[s][0]);
    split(b1, b.hi[s][1], b.lo[s][1]);
  }
}

// d[s] += a . b_s for kS0 <= s < kN: lo.hi unless a is TF32-valued
// (kAExact), hi.lo unless b is (kBExact), and hi.hi; each pass runs across
// the accumulators, so that no product waits on the one before it.  Both
// exact: one pass, the float32 product's sum of exact terms.
template <int kS0, int kN, bool kAExact, bool kBExact, int kM>
__device__ __forceinline__ void mma_passes(float (*d)[4], const FragA& a, const FragB<kM>& b) {
  if constexpr (!kAExact) {
#pragma unroll
    for (int s = kS0; s < kN; ++s) mma(d[s], a.lo, b.hi[s][0], b.hi[s][1]);
  }
  if constexpr (!kBExact) {
#pragma unroll
    for (int s = kS0; s < kN; ++s) mma(d[s], a.hi, b.lo[s][0], b.lo[s][1]);
  }
#pragma unroll
  for (int s = kS0; s < kN; ++s) mma(d[s], a.hi, b.hi[s][0], b.hi[s][1]);
}

// d[s] += a . b_s for s < kNT, b_s at b0[s * step] (row t) and b1[s * step]
// (row t + 4), four fragments at a time.
template <int kNT, bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_tiles(float (*d)[4], const FragA& a, const float* b0,
                                          const float* b1, int step) {
  constexpr int kQ = kNT < 4 ? kNT : 4;
#pragma unroll
  for (int q = 0; q < kNT; q += kQ) {
    FragB<kQ> b;
#pragma unroll
    for (int s = 0; s < kQ; ++s) set_b<kBExact>(b, s, b0[(q + s) * step], b1[(q + s) * step]);
    mma_passes<0, kQ, kAExact, kBExact>(d + q, a, b);
  }
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
template <bool kExact>
__device__ __forceinline__ void ldsm_a(FragA& a, const float* p) {
  uint32_t r[4];
  ldsm4(r, p);
  set_a<kExact>(a, __uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                __uint_as_float(r[3]));
}

// B fragments s0, s0 + 1 of a tile stored [n][k] (k contiguous), by
// ldmatrix: p is tile + (n0 + 8 s0 + lane % 8 + 8 (lane / 16)) ld +
// 4 (lane / 8 % 2) + k0.
template <bool kExact, int kN>
__device__ __forceinline__ void ldsm_b2(FragB<kN>& b, int s0, const float* p) {
  uint32_t r[4];
  ldsm4(r, p);
  set_b<kExact>(b, s0, __uint_as_float(r[0]), __uint_as_float(r[1]));
  set_b<kExact>(b, s0 + 1, __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// sc[s] = a_i . b_j over `width` for this warp's 16 rows (a_lane: its
// ldmatrix row of the A tile) and the 8-column blocks kFirst .. 3 of its
// half (b_lane: its ldmatrix row of the B tile, row stride ldb); blocks
// below kFirst are 0.  Passes as mma_passes.
template <int kFirst, bool kAExact, bool kBExact>
__device__ __forceinline__ void scores(float (*sc)[4], const float* a_lane, const float* b_lane,
                                       int ldb, int width) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[s][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < width; k0 += 8) {
    FragA a;
    ldsm_a<kAExact>(a, a_lane + k0);
    FragB<4> b;
    if constexpr (kFirst == 0) ldsm_b2<kBExact>(b, 0, b_lane + k0);
    ldsm_b2<kBExact>(b, 2, b_lane + 16 * ldb + k0);
    mma_passes<kFirst, 4, kAExact, kBExact>(sc, a, b);
  }
}

// scores<kFirst, ...> on the route the two tiles' bits allow.
template <int kFirst>
__device__ __forceinline__ void scores_route(float (*sc)[4], bool a_exact, bool b_exact,
                                             const float* a_lane, const float* b_lane, int ldb,
                                             int width) {
  if (a_exact && b_exact)
    scores<kFirst, true, true>(sc, a_lane, b_lane, ldb, width);
  else if (a_exact)
    scores<kFirst, true, false>(sc, a_lane, b_lane, ldb, width);
  else if (b_exact)
    scores<kFirst, false, true>(sc, a_lane, b_lane, ldb, width);
  else
    scores<kFirst, false, false>(sc, a_lane, b_lane, ldb, width);
}

// acc += sc . X over this warp's 8-column blocks s >= s_lo of the score
// tile: block s is one k-step whose index t stands for column 2t and t + 4
// for 2t + 1, so the accumulator's registers are the A fragment as they
// are; x_lane is X's row (32 half + 2t), column g (X row-major, rows = the
// score tile's columns, row stride ldx).  kBExact: X holds TF32 values.
template <int kNT, bool kBExact>
__device__ __forceinline__ void scores_times(float (*acc)[4], const float (*sc)[4],
                                             const float* x_lane, int ldx, int s_lo) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < s_lo) continue;
    FragA a;
    set_a<false>(a, sc[s][0], sc[s][2], sc[s][1], sc[s][3]);
    const float* x0 = x_lane + 8 * s * ldx;
    mma_tiles<kNT, false, kBExact>(acc, a, x0, x0 + ldx, 8);
  }
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

// Copies, asynchronously, into dst[r][col] (row stride ld) for r < nrows,
// col < wpad row r of src (row stride `stride` floats, `width` of them)
// where r < rows and col < width, else 0.  width and wpad are multiples of
// 4.  Not committed.
__device__ void copy_tile(float* dst, int ld, const float* __restrict__ src, size_t stride,
                          int nrows, int rows, int width, int wpad) {
  const int w4 = wpad / 4, step = blockDim.x / w4;
  const int col = (threadIdx.x % w4) * 4;
  if ((int)threadIdx.x >= step * w4) return;
  for (int r = threadIdx.x / w4; r < nrows; r += step) {
    const bool valid = r < rows && col < width;
    cp16(dst + r * ld + col, valid ? src + r * stride + col : src, valid);
  }
}

// Whether every word this thread copied by copy_tile(dst, ld, ..., nrows,
// ..., wpad) is a TF32 value (its low 13 mantissa bits zero, as a bf16
// value's are; the zero fill is).  Call it after the copies landed, inside
// __syncthreads_and.
__device__ bool copied_tf32(const float* dst, int ld, int nrows, int wpad) {
  const int w4 = wpad / 4, step = blockDim.x / w4;
  const int col = (threadIdx.x % w4) * 4;
  uint32_t low = 0;
  if ((int)threadIdx.x < step * w4)
    for (int r = threadIdx.x / w4; r < nrows; r += step) {
      const uint4 v = *reinterpret_cast<const uint4*>(dst + r * ld + col);
      low |= v.x | v.y | v.z | v.w;
    }
  return (low & 0x1fffu) == 0;
}

// The sum over the four lanes of a quad (the lanes t of one row g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum over the eight lanes g of one t (a column of a 16-row strip's
// fragment), in a fixed tree.
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ---------------------------------------------------------------- (a)

// The chunk-grad kernel's p columns: 32, 64 or 128 (1, 2 or 4 pieces of
// 32, so that each warp keeps one piece); the columns past P are zero.
__host__ __device__ constexpr int state_pw(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// Two stages of a token tile's c and dy, then the chunk's weights.
__host__ __device__ size_t state_stage_floats(int N, int P) {
  return (size_t)kT * ld_across(round_up(N, 16)) + (size_t)kT * ld_across(state_pw(P));
}

__host__ __device__ size_t state_smem_floats(int N, int P, int Q) {
  return 2 * state_stage_floats(N, P) + round_up(Q, kT);
}

// The split of the tokens over warps: ks groups of warps each sum every
// ks-th k-step (the forward's chunk-state kernel's rule).
__host__ __device__ constexpr int state_ksplit(int N, int P) {
  const int units = (round_up(N, 16) / 16) * (state_pw(P) / 32);
  const int ks = units > 8 ? 1 : units > 4 ? 2 : 4;
  const int most = kWarps / (state_pw(P) / 32);
  return ks < most ? ks : most;
}

// gst[b, c, h] = sum_i c_i (x) exp(cum_i) dy_i over chunk c, as an
// (N x tokens) . (tokens x P) product: A[n][i] = c[i][n] read down the c
// tile's columns (two passes where the tile holds TF32 values), B[i][p] =
// exp(cum_i) dy[i][p]; warps, groups and stages as in csrc/ssd.cu's
// ssd_chunk_state_kernel.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_grad_kernel(const float* __restrict__ dy, const float* __restrict__ cg,
                          const float* __restrict__ cum, float* __restrict__ gst, int L, int H,
                          int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int nm = round_up(N, 16), pp = state_pw(P);
  const int ldb = ld_across(nm), ldx = ld_across(pp), qpad = round_up(Q, kT);
  const int stage = (int)state_stage_floats(N, P);
  float* w = smem + 2 * stage;  // [qpad]  exp(cum_i)

  const int nc = L / Q, ntiles = (Q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc, b = idx / nc;
  const int grp = h / (H / G);
  const size_t tok0 = (size_t)b * L + (size_t)c * Q;

  // stage s: c tile [kT][ldb], then dy tile [kT][ldx]
  auto fetch = [&](int jt) {
    float* bs = smem + (jt & 1) * stage;
    const int j0 = jt * kT, rows = min(kT, Q - j0);
    copy_tile(bs, ldb, cg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, kT, rows, N, nm);
    copy_tile(bs + kT * ldb, ldx, dy + ((tok0 + j0) * H + h) * P, (size_t)H * P, kT, rows, P,
              pp);
    cp_commit();
  };
  fetch(0);
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;
  for (int k = threadIdx.x; k < qpad; k += kThreads) w[k] = k < Q ? expf(crow[k]) : 0.f;

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

  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) {
      fetch(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const float* bs = smem + (jt & 1) * stage;
    // tile jt (and on the first pass the weights) is in; is its c TF32-valued?
    const bool exact = __syncthreads_and(copied_tf32(bs, ldb, kT, nm));
    const float* xs = bs + kT * ldb;
    const int j0 = jt * kT, rows = min(kT, Q - j0);
    auto run = [&](auto ex) {
      constexpr bool kExact = decltype(ex)::value;
      for (int k0 = 8 * kpart; k0 < rows; k0 += 8 * ks) {
        const float w0 = w[j0 + k0 + t], w1 = w[j0 + k0 + t + 4];
        const float* b0 = bs + (k0 + t) * ldb + g;
        const float* b1 = b0 + 4 * ldb;
        const float* x0 = xs + (k0 + t) * ldx + p0 + g;
        FragB<4> bx;
#pragma unroll
        for (int s = 0; s < 4; ++s) set_b<false>(bx, s, w0 * x0[8 * s], w1 * x0[4 * ldx + 8 * s]);
#pragma unroll
        for (int r = 0; r < kMaxPieces; ++r) {
          const int m0 = 16 * (mt0 + r * mstep);
          if (m0 < nm) {
            FragA a;
            set_a<kExact>(a, b0[m0], b0[m0 + 8], b1[m0], b1[m0 + 8]);
            mma_passes<0, 4, kExact, false>(acc[r], a, bx);
          }
        }
      }
    };
    if (exact)
      run(Bool<true>());
    else
      run(Bool<false>());
    __syncthreads();  // stage jt & 1 is read: tile jt + 2 may land there
  }

  if (ks > 1) {  // the loop ended on a barrier: the stages are free
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

  float* out = gst + (((size_t)b * nc + c) * H + h) * N * P;
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

// For one (batch, head) and four consecutive elements of the N x P state,
// walking the chunks from the last: gst[c] (the chunk's sum_i exp(cum_i)
// c_i (x) dy_i) becomes G_{c+1}, and G_c = gst[c] + exp(cum_Q) G_{c+1};
// dh0 = G_0.  Each warp writes its part of D_c = <G_{c+1}, h_{c+1}> to
// dpart[b, c, h, slice] (h_{c+1} = states[c + 1], h_nc = h_final); dhf null
// is a zero dh_final (and then h_final is not read).  The loads of
// kPassBatch chunks are issued before their walk, as in the forward's pass.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_kernel(const float* __restrict__ cum, const float* __restrict__ states,
                          const float* __restrict__ hfin, const float* __restrict__ dhf,
                          float* __restrict__ gst, float* __restrict__ dh0,
                          float* __restrict__ dpart, int L, int H, int NP, int Q) {
  const int nc = L / Q;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = gridDim.x * kPassWarps, slice = blockIdx.x * kPassWarps + warp;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  const bool live = e < NP;  // every lane stays for the warp sums
  float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), hn = gv;
  if (live && dhf != nullptr) {
    gv = *reinterpret_cast<const float4*>(dhf + (size_t)bh * NP + e);
    hn = *reinterpret_cast<const float4*>(hfin + (size_t)bh * NP + e);
  }
  const float* last = cum + (size_t)bh * L + Q - 1;
  auto at = [&](int c) { return (((size_t)b * nc + c) * H + h) * NP + e; };
  for (int c1 = nc - 1; c1 >= 0; c1 -= kPassBatch) {
    float4 tv[kPassBatch], hc[kPassBatch];
    float dec[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = c1 - k;
      tv[k] = hc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      dec[k] = 0.f;
      if (c >= 0) {
        if (live) {
          tv[k] = *reinterpret_cast<const float4*>(gst + at(c));
          hc[k] = *reinterpret_cast<const float4*>(states + at(c));
        }
        dec[k] = expf(last[(size_t)c * Q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = c1 - k;
      if (c < 0) break;
      if (live) *reinterpret_cast<float4*>(gst + at(c)) = gv;
      float d = gv.x * hn.x + gv.y * hn.y + gv.z * hn.z + gv.w * hn.w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) dpart[(((size_t)b * nc + c) * H + h) * slices + slice] = d;
      gv = make_float4(fmaf(gv.x, dec[k], tv[k].x), fmaf(gv.y, dec[k], tv[k].y),
                       fmaf(gv.z, dec[k], tv[k].z), fmaf(gv.w, dec[k], tv[k].w));
      hn = hc[k];
    }
  }
  if (live) *reinterpret_cast<float4*>(dh0 + (size_t)bh * NP + e) = gv;
}

// ---------------------------------------------------------------- (c), (d)

// The diagonal tile's first live 8-column block of a half: the blocks of
// columns 32 hf + 8 s .. + 8 that lie wholly before the strip's first row
// r0 (c: columns i >= rows j are kept) hold only masked entries: 0, 2 or 4.
__device__ __forceinline__ int first_live(int r0, int hf) {
  const int d = r0 - 32 * hf - 7;
  return d <= 0 ? 0 : min(4, (d + 7) / 8);
}

// Shared memory of (c), from its base: the column tile's b and xdt (one
// stage's floats), two stages of a row tile's c and dy, G_{c+1} over the
// second stage (read before the loop only), the warp pairs' score
// exchange; then cum_j, two stages' cum_i, the warps' column sums and two
// pairs' strips of M's sums down the columns.
__host__ __device__ constexpr int cols_stage_floats(int nt, int pt) {
  return kT * (ld_along(8 * nt) + ld_along(8 * pt));
}
constexpr int kExchange = 8 * 2 * 16 * 32;  // 8 warp pairs, a 16 x 32 tile from each
__host__ __device__ constexpr int cols_exchange_at(int nt, int pt) {
  return 3 * cols_stage_floats(nt, pt) > 2 * cols_stage_floats(nt, pt) + 8 * nt * ld_across(8 * pt)
             ? 3 * cols_stage_floats(nt, pt)
             : 2 * cols_stage_floats(nt, pt) + 8 * nt * ld_across(8 * pt);
}
__host__ __device__ constexpr int cols_body_floats(int nt, int pt) {
  return cols_exchange_at(nt, pt) + kExchange;
}

__host__ __device__ size_t cols_smem_floats(int N, int P) {
  return (size_t)cols_body_floats(width_tiles(N), width_tiles(P)) + 15 * kT;
}

constexpr int kColsThreads = 512;  // 16 warps in (c)

// (c): the column tile j of one (batch, chunk, head), 16 warps.  Warp w:
// rows 16 (w % 4) .. + 16 of the tile, half hf = w / 4 % 2 of a row tile's
// columns, and side o = w / 8 of the outputs: accX holds its partial dxdt_j
// over p columns [8 kXT o, + 8 kXT), accB its partial db_j over n columns
// [8 kBT o, + 8 kBT).  The warps (strip, hf, 0) and (strip, hf, 1) are a
// pair: each tile pair, the first computes the scores b_j.c_i and the second
// xdt_j.dy_i over the pair's 16 x 32 entries, and they trade them through
// shared memory, so each holds both and each score product runs once.
template <int kNT, int kPT>
__global__ void __launch_bounds__(kColsThreads, 1)
ssd_bwd_cols_kernel(const float* __restrict__ xdt, const float* __restrict__ bg,
                    const float* __restrict__ cg, const float* __restrict__ dy,
                    const float* __restrict__ cum, const float* __restrict__ gst,
                    float* __restrict__ dx, float* __restrict__ db_h,
                    float* __restrict__ colterm, float* __restrict__ escore,
                    float* __restrict__ rowpart, int L, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = 8 * kNT, pp = 8 * kPT, kXT = kPT / 2, kBT = kNT / 2;
  constexpr int ldc = ld_along(np), ldx = ld_along(pp), ldg = ld_across(pp);
  constexpr int kStage = cols_stage_floats(kNT, kPT);
  float* bs = smem;                   // [kT][ldc]  b of the tile j
  float* xs = bs + kT * ldc;          // [kT][ldx]  xdt of the tile j
  float* stages = smem + kStage;      // stage s: c [kT][ldc], then dy [kT][ldx]
  float* gs = stages + kStage;       // [np][ldg]  G_{c+1}, over stage 1 before the loop
  float* xch = smem + cols_exchange_at(kNT, kPT);  // [pair][side][16 x 32]
  float* cum_j = smem + cols_body_floats(kNT, kPT);  // [kT]
  float* cum_i = cum_j + kT;                         // [2][kT]
  float* csum = cum_i + 2 * kT;                      // [hf][o][kT]
  float* rp = csum + 4 * kT;                         // [2][4][kT]

  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int jt = idx % nt;  // the longest column tile first: blocks run in index order
  idx /= nt;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc, b = idx / nc;
  const int grp = h / (H / G);
  const int j0 = jt * kT, rows = min(kT, Q - j0);
  const size_t tok0 = (size_t)b * L + (size_t)c * Q;
  const size_t unit = ((size_t)b * nc + c) * H + h;
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;
  float* eunit = escore + unit * pairs_of(nt) * kT * kT;
  float* rpart = rowpart + (unit * nt + jt) * Q;

  // row tile it into its stage, with its cumsum
  auto fetch = [&](int it) {
    const int k = (it - jt) & 1, i0 = it * kT, r = min(kT, Q - i0);
    float* cs = stages + k * kStage;
    copy_tile(cs, ldc, cg + ((tok0 + i0) * G + grp) * N, (size_t)G * N, kT, r, N, np);
    copy_tile(cs + kT * ldc, ldx, dy + ((tok0 + i0) * H + h) * P, (size_t)H * P, kT, r, P, pp);
    cp_commit();
    float* ci = cum_i + k * kT;
    for (int i = threadIdx.x; i < kT; i += kColsThreads) ci[i] = crow[min(i0 + i, Q - 1)];
  };
  // the row tile it's M sums down its columns, the strips in order
  auto flush_rows = [&](int it) {
    const float* s = rp + ((it - jt) & 1) * 4 * kT;
    const int x = threadIdx.x, i = it * kT + x;
    if (x < kT && i < Q) rpart[i] = ((s[x] + s[kT + x]) + s[2 * kT + x]) + s[3 * kT + x];
  };

  copy_tile(bs, ldc, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, kT, rows, N, np);
  copy_tile(xs, ldx, xdt + ((tok0 + j0) * H + h) * P, (size_t)H * P, kT, rows, P, pp);
  copy_tile(gs, ldg, gst + unit * N * P, P, np, N, P, pp);
  cp_commit();
  for (int i = threadIdx.x; i < kT; i += kColsThreads) cum_j[i] = crow[min(j0 + i, Q - 1)];
  const float cq = crow[Q - 1];
  fetch(jt);
  cp_wait<1>();
  const bool b_exact = __syncthreads_and(copied_tf32(bs, ldc, kT, np));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp & 3, hf = (warp >> 2) & 1, o = warp >> 3;
  const int r0 = 16 * strip, px = 8 * kXT * o, nb = 8 * kBT * o;
  const int arow = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const float* a_b = bs + arow * ldc + 4 * (lane >> 4);
  const float* a_x = xs + arow * ldx + 4 * (lane >> 4);
  float accX[kXT][4], accB[kBT][4];
#pragma unroll
  for (int q = 0; q < kXT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) accX[q][e] = 0.f;
#pragma unroll
  for (int q = 0; q < kBT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) accB[q][e] = 0.f;

  // the state terms over this half's k-steps, this side's columns: accX =
  // b_j . G (over N; two passes on a TF32-valued b), accB = xdt_j . G^T
  // (over P), then both times w_j
  auto state_b = [&](auto ex) {
    constexpr bool kExact = decltype(ex)::value;
#pragma unroll 2
    for (int k0 = 8 * hf; k0 < np; k0 += 16) {
      FragA a;
      ldsm_a<kExact>(a, a_b + k0);
      const float* b0 = gs + (k0 + t) * ldg + px + g;
      mma_tiles<kXT, kExact, false>(accX, a, b0, b0 + 4 * ldg, 8);
    }
  };
  if (b_exact)
    state_b(Bool<true>());
  else
    state_b(Bool<false>());
#pragma unroll 2
  for (int k0 = 8 * hf; k0 < pp; k0 += 16) {
    FragA a;
    ldsm_a<false>(a, a_x + k0);
    const float* b0 = gs + (nb + g) * ldg + k0 + t;
    mma_tiles<kBT, false, false>(accB, a, b0, b0 + 4, 8 * ldg);
  }
  const int ja = r0 + g, jb = ja + 8;
  const float cja = cum_j[ja], cjb = cum_j[jb];
  {
    const float wa = expf(cq - cja), wb = expf(cq - cjb);
#pragma unroll
    for (int q = 0; q < kXT; ++q) {
      accX[q][0] *= wa;
      accX[q][1] *= wa;
      accX[q][2] *= wb;
      accX[q][3] *= wb;
    }
#pragma unroll
    for (int q = 0; q < kBT; ++q) {
      accB[q][0] *= wa;
      accB[q][1] *= wa;
      accB[q][2] *= wb;
      accB[q][3] *= wb;
    }
  }
  // colterm's w part, + xdt_j . (dxdt_j's w part), this warp's share of it
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int q = 0; q < kXT; ++q) {
    const int p = px + 8 * q + 2 * t;
    sa += accX[q][0] * xs[ja * ldx + p] + accX[q][1] * xs[ja * ldx + p + 1];
    sb += accX[q][2] * xs[jb * ldx + p] + accX[q][3] * xs[jb * ldx + p + 1];
  }

  const int brow = 32 * hf + (lane & 7) + 8 * (lane >> 4);
  const int iw = 32 * hf;
  float* mine = xch + ((strip * 2 + hf) * 2 + o) * 512 + lane;
  const float* both = xch + (strip * 2 + hf) * 2 * 512 + lane;
  for (int it = jt; it < nt; ++it) {
    const int k = (it - jt) & 1;
    const float* cs = stages + k * kStage;
    const float* ys = cs + kT * ldc;
    const float* ci = cum_i + k * kT;
    cp_wait<0>();
    // the stage and its cumsum are in, every warp is done with the pair
    // before (and, on the first pass, with G): the other stage is free
    const bool c_exact = __syncthreads_and(copied_tf32(cs, ldc, kT, np));
    if (it + 1 < nt) fetch(it + 1);
    if (it > jt) flush_rows(it - 1);
    const bool diag = it == jt;
    const int s_lo = diag ? first_live(r0, hf) : 0;
    // this side's score tile, traded with the pair's other warp
    float sc[4][4], dp[4][4];
    {
      const float* b_c = cs + brow * ldc + 4 * ((lane >> 3) & 1);
      const float* b_y = ys + brow * ldx + 4 * ((lane >> 3) & 1);
      if (s_lo == 4) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[s][e] = 0.f;
      } else if (s_lo == 0) {
        if (o == 0)
          scores_route<0>(sc, b_exact, c_exact, a_b, b_c, ldc, np);  // b_j . c_i
        else
          scores<0, false, false>(sc, a_x, b_y, ldx, pp);            // xdt_j . dy_i
      } else {
        if (o == 0)
          scores_route<2>(sc, b_exact, c_exact, a_b, b_c, ldc, np);
        else
          scores<2, false, false>(sc, a_x, b_y, ldx, pp);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) mine[r * 32] = sc[r / 4][r % 4];
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + strip * 2 + hf) : "memory");
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        sc[r / 4][r % 4] = both[r * 32];
        dp[r / 4][r % 4] = both[512 + r * 32];
      }
    }
    float* et = eunit + (size_t)(it * (it + 1) / 2 + jt) * kT * kT;
    float* rps = rp + k * 4 * kT + strip * kT;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = iw + 8 * s + 2 * t;
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      if (s >= s_lo) {
        const float c0 = ci[i], c1 = ci[i + 1];
        // entry (row j, column i) is kept where i >= j on the diagonal tile;
        // a masked entry's exponent is 0 before exp and the entry 0 after.
        // __expf (ex2.approx of x log2 e), as the forward's decay
        const bool k0 = !diag || i >= ja, k1 = !diag || i + 1 >= ja;
        const bool k2 = !diag || i >= jb, k3 = !diag || i + 1 >= jb;
        const float l[4] = {k0 ? __expf(k0 ? c0 - cja : 0.f) : 0.f,
                            k1 ? __expf(k1 ? c1 - cja : 0.f) : 0.f,
                            k2 ? __expf(k2 ? c0 - cjb : 0.f) : 0.f,
                            k3 ? __expf(k3 ? c1 - cjb : 0.f) : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sl = sc[s][e] * l[e], el = dp[s][e] * l[e];
          // M off its diagonal, for the row j's and the column i's sums
          const bool off = !diag || i + (e & 1) != ((e & 2) ? jb : ja);
          m[e] = off ? sl * dp[s][e] : 0.f;
          sc[s][e] = sl;
          dp[s][e] = el;
        }
      }
      if (o == 0) {  // M's sums: the row j's into colterm, down the columns i, i + 1
        sa += m[0] + m[1];
        sb += m[2] + m[3];
        const float d0 = column_sum(m[0] + m[2]), d1 = column_sum(m[1] + m[3]);
        if (g == 0) *reinterpret_cast<float2*>(rps + i) = make_float2(d0, d1);
      } else {  // the decayed dy . xdt tile, [j][i], for (d)
        *reinterpret_cast<float2*>(et + ja * kT + i) = make_float2(dp[s][0], dp[s][1]);
        *reinterpret_cast<float2*>(et + jb * kT + i) = make_float2(dp[s][2], dp[s][3]);
      }
    }
    const float* y_lane = ys + (iw + 2 * t) * ldx + px + g;
    const float* c_lane = cs + (iw + 2 * t) * ldc + nb + g;
    scores_times<kXT, false>(accX, sc, y_lane, ldx, s_lo);  // += (S o L)^T dy_i
    if (c_exact)  // += (L o dP)^T c_i
      scores_times<kBT, true>(accB, dp, c_lane, ldc, s_lo);
    else
      scores_times<kBT, false>(accB, dp, c_lane, ldc, s_lo);
  }
  __syncthreads();  // every warp is done with the last pair
  flush_rows(nt - 1);

  // the halves' partial sums meet in shared memory (every tile is read)
  float* redX = smem;                 // [2][kT][ldx]
  float* redB = smem + 2 * kT * ldx;  // [2][kT][ldc]
  {
    float* rx = redX + hf * kT * ldx;
    float* rb = redB + hf * kT * ldc;
#pragma unroll
    for (int q = 0; q < kXT; ++q) {
      const int p = px + 8 * q + 2 * t;
      *reinterpret_cast<float2*>(rx + ja * ldx + p) = make_float2(accX[q][0], accX[q][1]);
      *reinterpret_cast<float2*>(rx + jb * ldx + p) = make_float2(accX[q][2], accX[q][3]);
    }
#pragma unroll
    for (int q = 0; q < kBT; ++q) {
      const int n = nb + 8 * q + 2 * t;
      *reinterpret_cast<float2*>(rb + ja * ldc + n) = make_float2(accB[q][0], accB[q][1]);
      *reinterpret_cast<float2*>(rb + jb * ldc + n) = make_float2(accB[q][2], accB[q][3]);
    }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
    if (t == 0) {
      csum[(hf * 2 + o) * kT + ja] = sa;
      csum[(hf * 2 + o) * kT + jb] = sb;
    }
  }
  __syncthreads();
  const int p4 = P / 4, n4 = N / 4;
  for (int e = threadIdx.x; e < rows * p4; e += kColsThreads) {
    const int i = e / p4, p = (e % p4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(redX + i * ldx + p);
    const float4 v = *reinterpret_cast<const float4*>(redX + (kT + i) * ldx + p);
    *reinterpret_cast<float4*>(dx + ((tok0 + j0 + i) * H + h) * P + p) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
  for (int e = threadIdx.x; e < rows * n4; e += kColsThreads) {
    const int i = e / n4, n = (e % n4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(redB + i * ldc + n);
    const float4 v = *reinterpret_cast<const float4*>(redB + (kT + i) * ldc + n);
    *reinterpret_cast<float4*>(db_h + ((tok0 + j0 + i) * H + h) * N + n) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
  float* ct = colterm + ((size_t)b * H + h) * L + (size_t)c * Q + j0;
  for (int i = threadIdx.x; i < rows; i += kColsThreads)
    ct[i] = ((csum[i] + csum[kT + i]) + csum[2 * kT + i]) + csum[3 * kT + i];
}

// Shared memory of (d): two stages of a column tile's decayed score tile
// [j][i] and its b, over which the inter part's dy_i, c_i and h_c tiles lie
// first; then the halves' row sums.
__host__ __device__ size_t rows_stage_floats(int N) {
  return (size_t)kT * (ld_across(kT) + ld_across(8 * width_tiles(N)));
}

__host__ __device__ size_t rows_body_floats(int N, int P) {
  const int np = 8 * width_tiles(N), pp = 8 * width_tiles(P);
  const size_t two = 2 * rows_stage_floats(N);
  const size_t inter =
      (size_t)kT * ld_along(pp) + (size_t)kT * ld_along(np) + (size_t)np * ld_along(pp);
  return two > inter ? two : inter;
}

__host__ __device__ size_t rows_smem_floats(int N, int P) {
  return rows_body_floats(N, P) + 2 * kT;
}

// (d): the row tile i of one (batch, chunk, head).  Warp w: rows 16 (w % 4)
// .. + 16, half w / 4 of dc's 8 kNT columns; acc (kNT / 2 tiles of 8)
// holds them.
template <int kNT, int kPT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_rows_kernel(const float* __restrict__ bg, const float* __restrict__ cg,
                    const float* __restrict__ dy, const float* __restrict__ cum,
                    const float* __restrict__ states, const float* __restrict__ escore,
                    const float* __restrict__ rowpart, float* __restrict__ dc_h,
                    float* __restrict__ rowterm, int L, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = 8 * kNT, pp = 8 * kPT, kHT = kNT / 2;
  constexpr int lde = ld_across(kT), ldb = ld_across(np);
  constexpr int ldy = ld_along(pp), ldc = ld_along(np), ldh = ld_along(pp);
  constexpr int kStage = kT * (lde + ldb);
  float* ys = smem;              // [kT][ldy]  dy of the tile i, before the loop
  float* cs = ys + kT * ldy;     // [kT][ldc]  c of the tile i
  float* hs = cs + kT * ldc;     // [np][ldh]  the state before the chunk
  float* rsum = smem + rows_body_floats(N, P);  // [2][kT]

  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int it = nt - 1 - idx % nt;  // the longest row tile first
  idx /= nt;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc, b = idx / nc;
  const int grp = h / (H / G);
  const int i0 = it * kT, rows = min(kT, Q - i0);
  const size_t tok0 = (size_t)b * L + (size_t)c * Q;
  const size_t unit = ((size_t)b * nc + c) * H + h;
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;
  const float* erow = escore + (unit * pairs_of(nt) + it * (it + 1) / 2) * kT * kT;

  copy_tile(ys, ldy, dy + ((tok0 + i0) * H + h) * P, (size_t)H * P, kT, rows, P, pp);
  copy_tile(cs, ldc, cg + ((tok0 + i0) * G + grp) * N, (size_t)G * N, kT, rows, N, np);
  copy_tile(hs, ldh, states + unit * N * P, P, np, N, P, pp);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), hf = warp >> 2, n0 = hf * 8 * kHT;
  const int ia = r0 + g, ib = ia + 8;
  const float cia = crow[min(i0 + ia, Q - 1)], cib = crow[min(i0 + ib, Q - 1)];
  const float* a_y = ys + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldy + 4 * (lane >> 4);
  float acc[kHT][4];
#pragma unroll
  for (int q = 0; q < kHT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  cp_wait<0>();
  __syncthreads();

  // the inter part of this half's columns: acc = dy_i . h_c^T over P, then
  // times exp(cum_i)
#pragma unroll 2
  for (int k0 = 0; k0 < pp; k0 += 8) {
    FragA a;
    ldsm_a<false>(a, a_y + k0);
    const float* b0 = hs + (n0 + g) * ldh + k0 + t;
    mma_tiles<kHT, false, false>(acc, a, b0, b0 + 4, 8 * ldh);
  }
  {
    const float ea = expf(cia), eb = expf(cib);
#pragma unroll
    for (int q = 0; q < kHT; ++q) {
      acc[q][0] *= ea;
      acc[q][1] *= ea;
      acc[q][2] *= eb;
      acc[q][3] *= eb;
    }
  }
  // rowterm's inter part, c_i . (dc_i's inter part), this half's columns
  float ra = 0.f, rb = 0.f;
#pragma unroll
  for (int q = 0; q < kHT; ++q) {
    const int n = n0 + 8 * q + 2 * t;
    ra += acc[q][0] * cs[ia * ldc + n] + acc[q][1] * cs[ia * ldc + n + 1];
    rb += acc[q][2] * cs[ib * ldc + n] + acc[q][3] * cs[ib * ldc + n + 1];
  }
  ra = quad_sum(ra);
  rb = quad_sum(rb);
  if (t == 0) {
    rsum[hf * kT + ia] = ra;
    rsum[hf * kT + ib] = rb;
  }
  __syncthreads();  // the inter tiles are read: the stages may land over them

  // column tile jt's score tile (i's row of pairs) and b into stage jt & 1
  auto fetch = [&](int jt) {
    float* es = smem + (jt & 1) * kStage;
    const int j0 = jt * kT;
    copy_tile(es, lde, erow + (size_t)jt * kT * kT, kT, kT, kT, kT, kT);
    copy_tile(es + kT * lde, ldb, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, kT,
              min(kT, Q - j0), N, np);
    cp_commit();
  };
  fetch(0);
  for (int jt = 0; jt <= it; ++jt) {
    const float* es = smem + (jt & 1) * kStage;
    const float* bs = es + kT * lde;
    cp_wait<0>();
    // stage jt & 1 is in, every warp is done with the tile before
    const bool b_exact = __syncthreads_and(copied_tf32(bs, ldb, kT, np));
    if (jt < it) fetch(jt + 1);
    // on the diagonal tile, the k-steps of columns j past the strip's
    // rows hold only masked (zero) entries
    const int kmax = jt == it ? r0 + 16 : kT;
    // acc += E^T b_j: A[i][j] = E[j][i] read down the tile's columns
    auto run = [&](auto ex) {
      constexpr bool kExact = decltype(ex)::value;
#pragma unroll 2
      for (int k0 = 0; k0 < kmax; k0 += 8) {
        const float* e0 = es + (k0 + t) * lde + r0 + g;
        const float* e1 = e0 + 4 * lde;
        FragA a;
        set_a<false>(a, e0[0], e0[8], e1[0], e1[8]);
        const float* b0 = bs + (k0 + t) * ldb + n0 + g;
        mma_tiles<kHT, false, kExact>(acc, a, b0, b0 + 4 * ldb, 8);
      }
    };
    if (b_exact)
      run(Bool<true>());
    else
      run(Bool<false>());
  }

#pragma unroll
  for (int q = 0; q < kHT; ++q) {
    const int n = n0 + 8 * q + 2 * t;  // N is even: n < N means n + 1 < N
    if (n >= N) continue;
    if (ia < rows)
      *reinterpret_cast<float2*>(dc_h + ((tok0 + i0 + ia) * H + h) * N + n) =
          make_float2(acc[q][0], acc[q][1]);
    if (ib < rows)
      *reinterpret_cast<float2*>(dc_h + ((tok0 + i0 + ib) * H + h) * N + n) =
          make_float2(acc[q][2], acc[q][3]);
  }
  // rowterm: the inter part's halves, then M's sums of the column tiles
  // j <= i in order
  float* rt = rowterm + ((size_t)b * H + h) * L + (size_t)c * Q + i0;
  const float* rpu = rowpart + unit * nt * Q + i0;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    float s = rsum[i] + rsum[kT + i];
    for (int jt = 0; jt <= it; ++jt) s += rpu[(size_t)jt * Q + i];
    rt[i] = s;
  }
}

// ---------------------------------------------------------------- (e)

// A warp per (batch, chunk, head): dcum_i = rowterm_i - colterm_i, D_c (its
// slices summed in order) added at the chunk's last token, and the reverse
// cumsum over the chunk into dda (B, L, H).
__global__ void __launch_bounds__(128)
ssd_bwd_dda_kernel(const float* __restrict__ rowterm, const float* __restrict__ colterm,
                   const float* __restrict__ dpart, float* __restrict__ dda, int B, int L, int H,
                   int Q, int slices) {
  const int lane = threadIdx.x & 31;
  const int nc = L / Q;
  const int wid = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (wid >= B * nc * H) return;
  const int h = wid % H, c = wid / H % nc, b = wid / H / nc;
  float d = 0.f;
  for (int s = lane; s < slices; s += 32) d += dpart[(size_t)wid * slices + s];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  const size_t base = ((size_t)b * H + h) * L + (size_t)c * Q;
  const int per = (Q + 31) / 32;
  const int s0 = min(lane * per, Q), s1 = min(s0 + per, Q);
  float total = 0.f;
  for (int k = s0; k < s1; ++k) total += rowterm[base + k] - colterm[base + k];
  float incl = total;  // the totals of this lane and the lanes after it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  float run = d + incl - total;
  for (int k = s1 - 1; k >= s0; --k) {
    run += rowterm[base + k] - colterm[base + k];
    dda[((size_t)b * L + (size_t)c * Q + k) * H + h] = run;
  }
}

// out[b, l, g, :] = sum over the group's heads, in head order, of
// per_head[b, l, h, :] (N / 4 float4 a row); blockIdx.y picks db or dc.
__global__ void __launch_bounds__(256)
ssd_bwd_group_sum_kernel(const float* __restrict__ db_h, const float* __restrict__ dc_h,
                         float* __restrict__ db, float* __restrict__ dc, long long rows, int H,
                         int G, int N) {
  const float* src = blockIdx.y == 0 ? db_h : dc_h;
  float* dst = blockIdx.y == 0 ? db : dc;
  const int n4 = N / 4, rep = H / G;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * G * n4) return;
  const int n = (int)(e % n4) * 4;
  const long long rg = e / n4;  // (b, l) * G + g
  const float* p = src + ((rg / G) * H + (rg % G) * rep) * N + n;
  float4 s = *reinterpret_cast<const float4*>(p);
  for (int k = 1; k < rep; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(p + (size_t)k * N);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  *reinterpret_cast<float4*>(dst + rg * N + n) = s;
}

template <int kNT, int kPT>
cudaError_t launch_tiles(const float* xdt, const float* b, const float* c, const float* dy,
                         const float* cum, const float* states, const float* gst, float* dx,
                         float* db_h, float* dc_h, float* colterm, float* rowterm, float* escore,
                         float* rowpart, int B, int L, int H, int G, int P, int N, int Q,
                         cudaStream_t stream) {
  const size_t smem_c = cols_smem_floats(N, P) * sizeof(float);
  const size_t smem_d = rows_smem_floats(N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_cols_kernel<kNT, kPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_rows_kernel<kNT, kPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_d);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((long long)B * (L / Q) * H * ((Q + kT - 1) / kT));
  ssd_bwd_cols_kernel<kNT, kPT><<<blocks, kColsThreads, smem_c, stream>>>(
      xdt, b, c, dy, cum, gst, dx, db_h, colterm, escore, rowpart, L, H, G, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_rows_kernel<kNT, kPT><<<blocks, kThreads, smem_d, stream>>>(
      b, c, dy, cum, states, escore, rowpart, dc_h, rowterm, L, H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block, in bytes: which 0 the chunk-grad kernel
// (a), 1 the column kernel (c), 2 the row kernel (d).
long long ssd_bwd_smem_bytes(int which, int N, int P, int Q) {
  const size_t f = which == 0   ? state_smem_floats(N, P, Q)
                   : which == 1 ? cols_smem_floats(N, P)
                                : rows_smem_floats(N, P);
  return (long long)(f * sizeof(float));
}

// Slices of D_c a (batch, chunk, head) gets from the pass: its warps.
int ssd_bwd_slices(int N, int P) {
  return (N * P / 4 + kPassThreads - 1) / kPassThreads * kPassWarps;
}

// The kernels on `stream`; returns the CUDA error of the first launch that
// failed (0 = all launched).  hfin and dhf are null together (a zero
// dh_final).
int ssd_bwd_launch(const void* xdt, const void* b, const void* c, const void* dy,
                   const void* cum, const void* states, const void* hfin, const void* dhf,
                   void* dx, void* dda, void* db, void* dc, void* dh0, void* gst, void* db_h,
                   void* dc_h, void* rowterm, void* colterm, void* dpart, void* escore,
                   void* rowpart, int B, int L, int H, int G, int P, int N, int Q,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* bg = static_cast<const float*>(b);
  const float* cg = static_cast<const float*>(c);
  const float* yg = static_cast<const float*>(dy);
  const float* cw = static_cast<const float*>(cum);
  const float* sw = static_cast<const float*>(states);
  float* gw = static_cast<float*>(gst);
  float* dbh = static_cast<float*>(db_h);
  float* dch = static_cast<float*>(dc_h);
  float* rt = static_cast<float*>(rowterm);
  float* ct = static_cast<float*>(colterm);
  float* dp = static_cast<float*>(dpart);
  float* es = static_cast<float*>(escore);
  float* rp = static_cast<float*>(rowpart);
  const int nc = L / Q;

  const size_t smem_a = state_smem_floats(N, P, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_grad_kernel<<<(unsigned)((long long)B * nc * H), kThreads, smem_a, st>>>(
      yg, cg, cw, gw, L, H, G, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int np4 = N * P / 4;
  ssd_bwd_state_pass_kernel<<<dim3((np4 + kPassThreads - 1) / kPassThreads, B * H),
                              kPassThreads, 0, st>>>(
      cw, sw, static_cast<const float*>(hfin), static_cast<const float*>(dhf), gw,
      static_cast<float*>(dh0), dp, L, H, N * P, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  float* dxo = static_cast<float*>(dx);
  const int nt = width_tiles(N), pt = width_tiles(P);
  if (nt == 8 && pt == 8)
    err = launch_tiles<8, 8>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, es, rp, B, L, H,
                             G, P, N, Q, st);
  else if (nt == 16 && pt == 8)
    err = launch_tiles<16, 8>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, es, rp, B, L, H,
                              G, P, N, Q, st);
  else if (nt == 8)
    err = launch_tiles<8, 16>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, es, rp, B, L, H,
                              G, P, N, Q, st);
  else  // N and P both above 64: more state pieces than (a) holds (kernel.py plan_bwd)
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  const int warps = B * nc * H;
  ssd_bwd_dda_kernel<<<(warps + 3) / 4, 128, 0, st>>>(rt, ct, dp, static_cast<float*>(dda), B,
                                                      L, H, Q, ssd_bwd_slices(N, P));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long rows = (long long)B * L;
  const long long items = rows * G * (N / 4);
  ssd_bwd_group_sum_kernel<<<dim3((unsigned)((items + 255) / 256), 2), 256, 0, st>>>(
      dbh, dch, static_cast<float*>(db), static_cast<float*>(dc), rows, H, G, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
