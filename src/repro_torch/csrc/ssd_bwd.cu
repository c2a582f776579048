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
// Q, H, slices).
//
// What bounds it on this card: operations.  Per chunk and head it takes
// three causal Q x Q x N products (the scores again, db's and dc's intra
// parts), two causal Q x Q x P ones (dy.xdt and dxdt's intra part) and four
// Q x N x P ones (dxdt's, db's and dc's state terms and the reverse pass's
// input): at Mamba2-1.3B's training shape about 2.4 times the forward's.
// As in the forward, every product is 3xTF32 on the tensor cores (hi/lo
// splits of both operands, lo.lo dropped): dy and xdt are not bf16-valued,
// and float32 is the function's type.  Bytes come next (the per-head db and
// dc workspaces, written once and read once by the group sums).
//
// What the design does about it (a first, simple design):
// - Five kernels a call, all on the current stream:
//   (a) ssd_bwd_chunk_grad_kernel, one block per (batch, chunk, head):
//       sum_i exp(cum_i) c_i (x) dy_i into gst (the forward's chunk-state
//       kernel with c for b, dy for xdt and exp(cum_i) for the weights).
//   (b) ssd_bwd_state_pass_kernel, per (batch, head, slice of N x P): the
//       reverse walk over chunks, in place: gst[c] becomes G_{c+1}; dh0;
//       each warp's part of D_c into dpart (summed in a fixed order later).
//   (c) ssd_bwd_cols_kernel, one block per (batch, chunk, head, 64-token
//       tile j): dxdt_j, db_j of the head, colterm_j (M's column sums and
//       the w term of dcum): first the state terms from G_{c+1}, then over
//       the row tiles i >= j the scores b_j.c_i and xdt_j.dy_i, decayed
//       and masked in registers, times dy_i and c_i.
//   (d) ssd_bwd_rows_kernel, one block per (batch, chunk, head, tile i):
//       dc_i of the head and rowterm_i (M's row sums and the inter term):
//       the inter part from h_c, then over the column tiles j <= i the
//       scores c_i.b_j and dy_i.xdt_j, decayed and masked, times b_j.
//       (c) and (d) each recompute the two score tiles of a tile pair:
//       seven Q x Q products where five would do, for two kernels without
//       atomics.
//   (e) ssd_bwd_dda_kernel, a warp per (batch, chunk, head): dcum and its
//       reverse cumsum, plus D_c; ssd_bwd_group_sum_kernel: db and dc
//       summed over each group's heads in head order.  Every sum runs in a
//       fixed order: two runs give the same bits.
// - In (c) and (d) the 8 warps are 4 row strips of 16 by 2 halves: the
//   halves split the state products over their contraction and the score
//   tiles over their 32 columns, and their partial sums meet in shared
//   memory at the end.  The masked half's exponent, cum_i - cum_j for
//   i < j, positive and large with realistic da, is replaced by 0 before
//   exp and the entry by 0 after, so it is never evaluated.  The diagonal
//   tile is computed whole and masked (the forward skips its upper 8-column
//   blocks; not yet here).
// - Tiles are staged by cp.async into row layouts whose strides make every
//   fragment read conflict-free (4 mod 32 words along the contraction, as
//   in the forward), one stage at a time: no copy overlaps a product yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // token tile: rows and columns of a chunk
constexpr int kThreads = 256;     // 8 warps, in (a), (c) and (d)
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 128;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kMaxPieces = 2;     // 16-row tiles of a chunk's state a warp in (a)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row stride (words) of a tile whose fragments read along its rows: 4 mod 32.
__host__ __device__ constexpr int ld_along(int w) { return round_up(w, 32) + 4; }
// Row stride of a tile whose fragments read down its columns: 8 mod 32.
__host__ __device__ constexpr int ld_across(int w) { return round_up(w, 32) + 8; }
// Tiles of 8 columns (c) and (d) keep of an N or P wide operand: 8 or 16
// (the kernels' instantiations); the columns past N or P are zero.
__host__ __device__ constexpr int width_tiles(int w) { return w <= 64 ? 8 : 16; }

// hi = x cut to TF32, lo = x - hi (exact in float32): the 3xTF32 split of
// csrc/ssd.cu.  A finite x only.
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

// d[s] += a . b_s in 3xTF32 for s < kN: the three passes (lo.hi, hi.lo,
// hi.hi) run across the kN accumulators.
template <int kN>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragB<kN>& b) {
#pragma unroll
  for (int s = 0; s < kN; ++s) mma(d[s], a.lo, b.hi[s][0], b.hi[s][1]);
#pragma unroll
  for (int s = 0; s < kN; ++s) mma(d[s], a.hi, b.lo[s][0], b.lo[s][1]);
#pragma unroll
  for (int s = 0; s < kN; ++s) mma(d[s], a.hi, b.hi[s][0], b.hi[s][1]);
}

// d[s] += a . b_s for s < kNT, b_s at b0[s * step] (row t) and b1[s * step]
// (row t + 4), four fragments at a time.
template <int kNT>
__device__ __forceinline__ void mma_tiles(float (*d)[4], const FragA& a, const float* b0,
                                          const float* b1, int step) {
  constexpr int kQ = kNT < 4 ? kNT : 4;
#pragma unroll
  for (int q = 0; q < kNT; q += kQ) {
    FragB<kQ> b;
#pragma unroll
    for (int s = 0; s < kQ; ++s) split_b(b, s, b0[(q + s) * step], b1[(q + s) * step]);
    mma3<kQ>(d + q, a, b);
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

// sc[s] = a_i . b_j over `width` for this warp's 16 rows (a_lane: its
// ldmatrix row of the A tile) and the four 8-column blocks of its half
// (b_lane: its ldmatrix row of the B tile, row stride ldb), in 3xTF32.
__device__ __forceinline__ void scores4(float (*sc)[4], const float* a_lane, const float* b_lane,
                                        int ldb, int width) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[s][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < width; k0 += 8) {
    FragA a;
    ldsm_a(a, a_lane + k0);
    FragB<4> b;
    ldsm_b2(b, 0, b_lane + k0);
    ldsm_b2(b, 2, b_lane + 16 * ldb + k0);
    mma3<4>(sc, a, b);
  }
}

// acc += sc . X over this warp's four 8-column blocks of the score tile:
// block s is one k-step whose index t stands for column 2t and t + 4 for
// 2t + 1, so the accumulator's registers are the A fragment as they are;
// x_lane is X's row (32 half + 2t), column g (X row-major, rows = the
// score tile's columns, row stride ldx).
template <int kNT>
__device__ __forceinline__ void scores_times(float (*acc)[4], const float (*sc)[4],
                                             const float* x_lane, int ldx) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    FragA a;
    split_a(a, sc[s][0], sc[s][2], sc[s][1], sc[s][3]);
    const float* x0 = x_lane + 8 * s * ldx;
    mma_tiles<kNT>(acc, a, x0, x0 + ldx, 8);
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

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// The sum over the four lanes of a quad (the lanes t of one row g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// gst[b, c, h] = sum_i exp(cum_i) c_i (x) dy_i over chunk c, as an
// (N x tokens) . (tokens x P) product: A[n][i] = exp(cum_i) c[i][n] read
// down the c tile's columns, B[i][p] = dy[i][p]; warps, groups and stages
// as in csrc/ssd.cu's ssd_chunk_state_kernel.
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
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      cp_wait_all();
    }
    __syncthreads();  // tile jt (and on the first pass the weights) is in
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
          FragA a;
          split_a(a, w0 * b0[m0], w0 * b0[m0 + 8], w1 * b1[m0], w1 * b1[m0 + 8]);
          mma3<4>(acc[r], a, bx);
        }
      }
    }
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
// is a zero dh_final (and then h_final is not read).
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
  for (int c = nc - 1; c >= 0; --c) {
    const size_t off = (((size_t)b * nc + c) * H + h) * NP + e;
    float4 tv = make_float4(0.f, 0.f, 0.f, 0.f), hc = tv;
    if (live) {
      tv = *reinterpret_cast<const float4*>(gst + off);
      hc = *reinterpret_cast<const float4*>(states + off);
      *reinterpret_cast<float4*>(gst + off) = gv;
    }
    float d = gv.x * hn.x + gv.y * hn.y + gv.z * hn.z + gv.w * hn.w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) dpart[(((size_t)b * nc + c) * H + h) * slices + slice] = d;
    const float dec = expf(last[(size_t)c * Q]);
    gv = make_float4(fmaf(gv.x, dec, tv.x), fmaf(gv.y, dec, tv.y), fmaf(gv.z, dec, tv.z),
                     fmaf(gv.w, dec, tv.w));
    hn = hc;
  }
  if (live) *reinterpret_cast<float4*>(dh0 + (size_t)bh * NP + e) = gv;
}

// ---------------------------------------------------------------- (c), (d)

// Shared memory of (c) and (d) before their small arrays: four token tiles
// (two of N columns, two of P), over the last two of which the state tile
// (N rows of P) lies first, and over all four the two halves' partial sums
// at the end.
__host__ __device__ size_t tiles_body_floats(int N, int P) {
  const int np = 8 * width_tiles(N), pp = 8 * width_tiles(P);
  const size_t pair = (size_t)kT * (ld_along(np) + ld_along(pp));
  const size_t with_state = pair + (size_t)np * ld_across(pp);
  return 2 * pair > with_state ? 2 * pair : with_state;
}

__host__ __device__ size_t tiles_smem_floats(int N, int P) {
  return tiles_body_floats(N, P) + 4 * kT;
}

// Decay and mask of one 8-column block of a score tile held [row][col] with
// rows at tile positions ra, rb = ra + 8 and columns col, col + 1, where
// the exponent of an entry is cum(later) - cum(earlier) and entries whose
// column comes before their row (kColsLater: after it) on the diagonal tile
// are masked.  Returns the four factors; a masked entry's exponent is 0.
template <bool kColsLater>
__device__ __forceinline__ void decay4(float l[4], bool diag, int ra, int rb, int col,
                                       float cra, float crb, float cc0, float cc1) {
  bool k[4];
  if (kColsLater) {  // entry (row j, column i): i >= j
    k[0] = !diag || col >= ra;
    k[1] = !diag || col + 1 >= ra;
    k[2] = !diag || col >= rb;
    k[3] = !diag || col + 1 >= rb;
    l[0] = k[0] ? expf(k[0] ? cc0 - cra : 0.f) : 0.f;
    l[1] = k[1] ? expf(k[1] ? cc1 - cra : 0.f) : 0.f;
    l[2] = k[2] ? expf(k[2] ? cc0 - crb : 0.f) : 0.f;
    l[3] = k[3] ? expf(k[3] ? cc1 - crb : 0.f) : 0.f;
  } else {  // entry (row i, column j): j <= i
    k[0] = !diag || col <= ra;
    k[1] = !diag || col + 1 <= ra;
    k[2] = !diag || col <= rb;
    k[3] = !diag || col + 1 <= rb;
    l[0] = k[0] ? expf(k[0] ? cra - cc0 : 0.f) : 0.f;
    l[1] = k[1] ? expf(k[1] ? cra - cc1 : 0.f) : 0.f;
    l[2] = k[2] ? expf(k[2] ? crb - cc0 : 0.f) : 0.f;
    l[3] = k[3] ? expf(k[3] ? crb - cc1 : 0.f) : 0.f;
  }
}

// (c): the token tile j of one (batch, chunk, head).  Warp w: rows 16 (w %
// 4) .. + 16 of the tile, half w / 4.  accX (kPT tiles of 8 p columns) and
// accB (kNT tiles of 8 n columns) hold the warp's partial dxdt_j and db_j.
template <int kNT, int kPT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cols_kernel(const float* __restrict__ xdt, const float* __restrict__ bg,
                    const float* __restrict__ cg, const float* __restrict__ dy,
                    const float* __restrict__ cum, const float* __restrict__ gst,
                    float* __restrict__ dx, float* __restrict__ db_h,
                    float* __restrict__ colterm, int L, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = 8 * kNT, pp = 8 * kPT;
  constexpr int ldc = ld_along(np), ldx = ld_along(pp), ldg = ld_across(pp);
  float* bs = smem;             // [kT][ldc]  b of the tile j
  float* xs = bs + kT * ldc;    // [kT][ldx]  xdt of the tile j
  float* cs = xs + kT * ldx;    // [kT][ldc]  c of a tile i
  float* ys = cs + kT * ldc;    // [kT][ldx]  dy of a tile i
  float* gs = cs;               // [np][ldg]  G_{c+1}, before the loop
  float* cum_j = smem + tiles_body_floats(N, P);  // [kT]
  float* cum_i = cum_j + kT;                       // [kT]
  float* csum = cum_i + kT;                        // [2][kT]

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
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;

  copy_tile(bs, ldc, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, kT, rows, N, np);
  copy_tile(xs, ldx, xdt + ((tok0 + j0) * H + h) * P, (size_t)H * P, kT, rows, P, pp);
  copy_tile(gs, ldg, gst + (((size_t)b * nc + c) * H + h) * N * P, P, np, N, P, pp);
  cp_commit();
  for (int i = threadIdx.x; i < kT; i += kThreads) cum_j[i] = crow[min(j0 + i, Q - 1)];
  const float cq = crow[Q - 1];
  cp_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), hf = warp >> 2;
  const int arow = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const float* a_b = bs + arow * ldc + 4 * (lane >> 4);
  const float* a_x = xs + arow * ldx + 4 * (lane >> 4);
  float accX[kPT][4], accB[kNT][4];
#pragma unroll
  for (int q = 0; q < kPT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) accX[q][e] = 0.f;
#pragma unroll
  for (int q = 0; q < kNT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) accB[q][e] = 0.f;

  // the state terms over this half's k-steps: accX = b_j . G (over N),
  // accB = xdt_j . G^T (over P), then both times w_j
#pragma unroll 2
  for (int k0 = 8 * hf; k0 < np; k0 += 16) {
    FragA a;
    ldsm_a(a, a_b + k0);
    const float* b0 = gs + (k0 + t) * ldg + g;
    mma_tiles<kPT>(accX, a, b0, b0 + 4 * ldg, 8);
  }
#pragma unroll 2
  for (int k0 = 8 * hf; k0 < pp; k0 += 16) {
    FragA a;
    ldsm_a(a, a_x + k0);
    const float* b0 = gs + g * ldg + k0 + t;
    mma_tiles<kNT>(accB, a, b0, b0 + 4, 8 * ldg);
  }
  const int ja = r0 + g, jb = ja + 8;
  const float cja = cum_j[ja], cjb = cum_j[jb];
  {
    const float wa = expf(cq - cja), wb = expf(cq - cjb);
#pragma unroll
    for (int q = 0; q < kPT; ++q) {
      accX[q][0] *= wa;
      accX[q][1] *= wa;
      accX[q][2] *= wb;
      accX[q][3] *= wb;
    }
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      accB[q][0] *= wa;
      accB[q][1] *= wa;
      accB[q][2] *= wb;
      accB[q][3] *= wb;
    }
  }
  // colterm's w part, + xdt_j . (dxdt_j's w part), this half's share of it
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int q = 0; q < kPT; ++q) {
    const int p = 8 * q + 2 * t;
    sa += accX[q][0] * xs[ja * ldx + p] + accX[q][1] * xs[ja * ldx + p + 1];
    sb += accX[q][2] * xs[jb * ldx + p] + accX[q][3] * xs[jb * ldx + p + 1];
  }
  __syncthreads();  // G (under the c and dy tiles) is read

  const int brow = 32 * hf + (lane & 7) + 8 * (lane >> 4);
  const float* b_c = cs + brow * ldc + 4 * ((lane >> 3) & 1);
  const float* b_y = ys + brow * ldx + 4 * ((lane >> 3) & 1);
  const int iw = 32 * hf;
  for (int it = jt; it < nt; ++it) {
    const int i0 = it * kT;
    copy_tile(cs, ldc, cg + ((tok0 + i0) * G + grp) * N, (size_t)G * N, kT, min(kT, Q - i0), N,
              np);
    copy_tile(ys, ldx, dy + ((tok0 + i0) * H + h) * P, (size_t)H * P, kT, min(kT, Q - i0), P,
              pp);
    cp_commit();
    for (int i = threadIdx.x; i < kT; i += kThreads) cum_i[i] = crow[min(i0 + i, Q - 1)];
    cp_wait_all();
    __syncthreads();  // tile i and cum_i are in
    float sc[4][4], dp[4][4];
    scores4(sc, a_b, b_c, ldc, np);  // b_j . c_i
    scores4(dp, a_x, b_y, ldx, pp);  // xdt_j . dy_i
    const bool diag = it == jt;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = iw + 8 * s + 2 * t;
      float l[4];
      decay4<true>(l, diag, ja, jb, i, cja, cjb, cum_i[i], cum_i[i + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sl = sc[s][e] * l[e], el = dp[s][e] * l[e];
        // M's column sum for the row j, its diagonal left out
        const bool off = !diag || i + (e & 1) != ((e & 2) ? jb : ja);
        const float m = off ? sl * dp[s][e] : 0.f;
        if (e < 2)
          sa += m;
        else
          sb += m;
        sc[s][e] = sl;
        dp[s][e] = el;
      }
    }
    const float* y_lane = ys + (iw + 2 * t) * ldx + g;
    scores_times<kPT>(accX, sc, y_lane, ldx);  // += (S o L)^T dy_i
    const float* c_lane = cs + (iw + 2 * t) * ldc + g;
    scores_times<kNT>(accB, dp, c_lane, ldc);  // += (L o dP)^T c_i
    __syncthreads();  // every warp is done with tile i and cum_i
  }

  // the halves' partial sums meet in shared memory (every tile is read)
  float* redX = smem;                 // [2][kT][ldx]
  float* redB = smem + 2 * kT * ldx;  // [2][kT][ldc]
  {
    float* px = redX + hf * kT * ldx;
    float* pb = redB + hf * kT * ldc;
#pragma unroll
    for (int q = 0; q < kPT; ++q) {
      const int p = 8 * q + 2 * t;
      *reinterpret_cast<float2*>(px + ja * ldx + p) = make_float2(accX[q][0], accX[q][1]);
      *reinterpret_cast<float2*>(px + jb * ldx + p) = make_float2(accX[q][2], accX[q][3]);
    }
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int n = 8 * q + 2 * t;
      *reinterpret_cast<float2*>(pb + ja * ldc + n) = make_float2(accB[q][0], accB[q][1]);
      *reinterpret_cast<float2*>(pb + jb * ldc + n) = make_float2(accB[q][2], accB[q][3]);
    }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
    if (t == 0) {
      csum[hf * kT + ja] = sa;
      csum[hf * kT + jb] = sb;
    }
  }
  __syncthreads();
  const int p4 = P / 4, n4 = N / 4;
  for (int e = threadIdx.x; e < rows * p4; e += kThreads) {
    const int i = e / p4, p = (e % p4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(redX + i * ldx + p);
    const float4 v = *reinterpret_cast<const float4*>(redX + (kT + i) * ldx + p);
    *reinterpret_cast<float4*>(dx + ((tok0 + j0 + i) * H + h) * P + p) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
  for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
    const int i = e / n4, n = (e % n4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(redB + i * ldc + n);
    const float4 v = *reinterpret_cast<const float4*>(redB + (kT + i) * ldc + n);
    *reinterpret_cast<float4*>(db_h + ((tok0 + j0 + i) * H + h) * N + n) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
  float* ct = colterm + ((size_t)b * H + h) * L + (size_t)c * Q + j0;
  for (int i = threadIdx.x; i < rows; i += kThreads) ct[i] = csum[i] + csum[kT + i];
}

// (d): the token tile i of one (batch, chunk, head).  Warps as in (c); acc
// (kNT tiles of 8 n columns) holds the warp's partial dc_i.
template <int kNT, int kPT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_rows_kernel(const float* __restrict__ xdt, const float* __restrict__ bg,
                    const float* __restrict__ cg, const float* __restrict__ dy,
                    const float* __restrict__ cum, const float* __restrict__ states,
                    float* __restrict__ dc_h, float* __restrict__ rowterm, int L, int H, int G,
                    int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = 8 * kNT, pp = 8 * kPT;
  constexpr int ldc = ld_along(np), ldx = ld_along(pp), ldh = ld_along(pp);
  float* cs = smem;             // [kT][ldc]  c of the tile i
  float* ys = cs + kT * ldc;    // [kT][ldx]  dy of the tile i
  float* bs = ys + kT * ldx;    // [kT][ldc]  b of a tile j
  float* xs = bs + kT * ldc;    // [kT][ldx]  xdt of a tile j
  float* hs = bs;               // [np][ldh]  the state before the chunk, before the loop
  float* cum_i = smem + tiles_body_floats(N, P);  // [kT]
  float* cum_j = cum_i + kT;                       // [kT]
  float* rsum = cum_j + kT;                        // [2][kT]

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
  const float* crow = cum + ((size_t)b * H + h) * L + (size_t)c * Q;

  copy_tile(cs, ldc, cg + ((tok0 + i0) * G + grp) * N, (size_t)G * N, kT, rows, N, np);
  copy_tile(ys, ldx, dy + ((tok0 + i0) * H + h) * P, (size_t)H * P, kT, rows, P, pp);
  copy_tile(hs, ldh, states + (((size_t)b * nc + c) * H + h) * N * P, P, np, N, P, pp);
  cp_commit();
  for (int i = threadIdx.x; i < kT; i += kThreads) cum_i[i] = crow[min(i0 + i, Q - 1)];
  cp_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), hf = warp >> 2;
  const int arow = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const float* a_c = cs + arow * ldc + 4 * (lane >> 4);
  const float* a_y = ys + arow * ldx + 4 * (lane >> 4);
  float acc[kNT][4];
#pragma unroll
  for (int q = 0; q < kNT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  // the inter part over this half's k-steps of P: acc = dy_i . h_c^T, then
  // times exp(cum_i)
#pragma unroll 2
  for (int k0 = 8 * hf; k0 < pp; k0 += 16) {
    FragA a;
    ldsm_a(a, a_y + k0);
    const float* b0 = hs + g * ldh + k0 + t;
    mma_tiles<kNT>(acc, a, b0, b0 + 4, 8 * ldh);
  }
  const int ia = r0 + g, ib = ia + 8;
  const float cia = cum_i[ia], cib = cum_i[ib];
  {
    const float ea = expf(cia), eb = expf(cib);
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      acc[q][0] *= ea;
      acc[q][1] *= ea;
      acc[q][2] *= eb;
      acc[q][3] *= eb;
    }
  }
  // rowterm's inter part, c_i . (dc_i's inter part), this half's share
  float ra = 0.f, rb = 0.f;
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
    const int n = 8 * q + 2 * t;
    ra += acc[q][0] * cs[ia * ldc + n] + acc[q][1] * cs[ia * ldc + n + 1];
    rb += acc[q][2] * cs[ib * ldc + n] + acc[q][3] * cs[ib * ldc + n + 1];
  }
  __syncthreads();  // the state (under the b and xdt tiles) is read

  const int brow = 32 * hf + (lane & 7) + 8 * (lane >> 4);
  const float* b_b = bs + brow * ldc + 4 * ((lane >> 3) & 1);
  const float* b_x = xs + brow * ldx + 4 * ((lane >> 3) & 1);
  const int jw = 32 * hf;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    copy_tile(bs, ldc, bg + ((tok0 + j0) * G + grp) * N, (size_t)G * N, kT, min(kT, Q - j0), N,
              np);
    copy_tile(xs, ldx, xdt + ((tok0 + j0) * H + h) * P, (size_t)H * P, kT, min(kT, Q - j0), P,
              pp);
    cp_commit();
    for (int j = threadIdx.x; j < kT; j += kThreads) cum_j[j] = crow[min(j0 + j, Q - 1)];
    cp_wait_all();
    __syncthreads();  // tile j and cum_j are in
    float sc[4][4], dp[4][4];
    scores4(sc, a_c, b_b, ldc, np);  // c_i . b_j
    scores4(dp, a_y, b_x, ldx, pp);  // dy_i . xdt_j
    const bool diag = jt == it;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = jw + 8 * s + 2 * t;
      float l[4];
      decay4<false>(l, diag, ia, ib, j, cia, cib, cum_j[j], cum_j[j + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float el = dp[s][e] * l[e];
        // M's row sum for the row i, its diagonal left out
        const bool off = !diag || j + (e & 1) != ((e & 2) ? ib : ia);
        const float m = off ? sc[s][e] * el : 0.f;
        if (e < 2)
          ra += m;
        else
          rb += m;
        dp[s][e] = el;
      }
    }
    const float* b_lane = bs + (jw + 2 * t) * ldc + g;
    scores_times<kNT>(acc, dp, b_lane, ldc);  // += (L o dP) b_j
    __syncthreads();  // every warp is done with tile j and cum_j
  }

  float* red = smem;  // [2][kT][ldc]
  {
    float* pc = red + hf * kT * ldc;
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int n = 8 * q + 2 * t;
      *reinterpret_cast<float2*>(pc + ia * ldc + n) = make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(pc + ib * ldc + n) = make_float2(acc[q][2], acc[q][3]);
    }
    ra = quad_sum(ra);
    rb = quad_sum(rb);
    if (t == 0) {
      rsum[hf * kT + ia] = ra;
      rsum[hf * kT + ib] = rb;
    }
  }
  __syncthreads();
  const int n4 = N / 4;
  for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
    const int i = e / n4, n = (e % n4) * 4;
    const float4 u = *reinterpret_cast<const float4*>(red + i * ldc + n);
    const float4 v = *reinterpret_cast<const float4*>(red + (kT + i) * ldc + n);
    *reinterpret_cast<float4*>(dc_h + ((tok0 + i0 + i) * H + h) * N + n) =
        make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
  float* rt = rowterm + ((size_t)b * H + h) * L + (size_t)c * Q + i0;
  for (int i = threadIdx.x; i < rows; i += kThreads) rt[i] = rsum[i] + rsum[kT + i];
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
                         float* db_h, float* dc_h, float* colterm, float* rowterm, int B, int L,
                         int H, int G, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = tiles_smem_floats(N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_cols_kernel<kNT, kPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_rows_kernel<kNT, kPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((long long)B * (L / Q) * H * ((Q + kT - 1) / kT));
  ssd_bwd_cols_kernel<kNT, kPT><<<blocks, kThreads, smem, stream>>>(
      xdt, b, c, dy, cum, gst, dx, db_h, colterm, L, H, G, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_rows_kernel<kNT, kPT><<<blocks, kThreads, smem, stream>>>(
      xdt, b, c, dy, cum, states, dc_h, rowterm, L, H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block, in bytes: which 0 the chunk-grad kernel
// (a), 1 the tile kernels (c) and (d).
long long ssd_bwd_smem_bytes(int which, int N, int P, int Q) {
  const size_t f = which == 0 ? state_smem_floats(N, P, Q) : tiles_smem_floats(N, P);
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
                   void* dc_h, void* rowterm, void* colterm, void* dpart, int B, int L, int H,
                   int G, int P, int N, int Q, void* stream) {
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
    err = launch_tiles<8, 8>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, B, L, H, G, P, N,
                             Q, st);
  else if (nt == 16 && pt == 8)
    err = launch_tiles<16, 8>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, B, L, H, G, P, N,
                              Q, st);
  else if (nt == 8)
    err = launch_tiles<8, 16>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, B, L, H, G, P, N,
                              Q, st);
  else
    err = launch_tiles<16, 16>(x, bg, cg, yg, cw, sw, gw, dxo, dbh, dch, ct, rt, B, L, H, G, P,
                               N, Q, st);
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
