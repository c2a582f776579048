// Mamba2's chunked SSD scan (state-space duality), for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd, _kernel).  For each (batch, head) it walks the chunks of Q tokens in
// order, carrying the (N, P) float32 state.  In a chunk, with cum the
// inclusive cumsum of da:
//   y_i   = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) xdt_j      (intra)
//         + exp(cum_i) (c_i . state)                               (inter)
//   state = state exp(cum_Q) + sum_j exp(cum_Q - cum_j) b_j (x) xdt_j
//
// Layouts (the reference's, unchanged), all float32 and contiguous:
//   xdt (B, L, H, P)   da (B, L, H)   b, c (B, L, H, N)   h0 (B, H, N, P)
//   y   (B, L, H, P)   h_final (B, H, N, P)
// L is a multiple of Q (the wrapper pads with da = 0 and zero inputs); N and
// P are multiples of 4; any Q.
//
// What bounds it on this card: float32 operations.  At Mamba2-1.3B's prefill
// shape (Q 256, N 128, P 64) a chunk needs ~21 MFLOP of products (the causal
// half of its two Q x Q products and its two Q x N x P products) for ~0.4 MB
// of inputs and outputs, about 52 operations per byte, above the float32
// CUDA-core line (67 TFLOP/s over 3.35 TB/s = 20).  The TPU kernel's math is float32 and so
// is this kernel's: no TF32, no bf16 tensor cores.
//
// What the design does about it:
// - One block per (batch, head); the chunk axis, sequential on the TPU's
//   grid, is a loop inside the block, and the state stays in shared memory
//   (N * P * 4 = 32 KB at full width) from the first chunk to the last.
// - The TPU block (a whole chunk's b and c, 128 KB each, and its Q x Q
//   scores, 256 KB) does not fit in 227 KB of shared memory.  The chunk is
//   cut into 64-token row tiles i and column tiles j; only one 64 x 64 tile
//   of scores exists at a time, and tiles with j0 > i0 are never computed:
//   the masked half costs no operations, and its exponent cum_i - cum_j,
//   positive and large with realistic da, is never evaluated (nor factored
//   as exp(cum_i) exp(-cum_j), which overflows the same way).
// - Every product is a shared-memory tile product in which each thread
//   accumulates 4 x 4 outputs in registers with CUDA-core FMAs; operands
//   read along the contraction are stored transposed (c and b as [n][token])
//   so that each step reads 16-byte vectors.
// - The state update is folded into the last row tile's column loop, after
//   every row tile of the chunk has read the state it starts from.
//
// Known limits of this first version, left for a later change: one block of
// 8 warps per SM (158 KB of shared memory at full width), no tensor cores,
// and b / xdt tiles read once per (row tile, column tile) pair from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;        // token tile: rows i and columns j of a chunk
constexpr int kLdT = kT + 4;  // row length of token-indexed shared tiles
constexpr int kThreads = 256;
static_assert((kT / 4) * (kT / 4) == kThreads, "one 4 x 4 score block per thread");

// acc[r][c] = sum_k A(m0 + r, k) ks[k] B[k][n0 + c].  A(m, k) is
// a[k * lda + m] when kAKMajor (four rows are one 16-byte read), else
// a[m * lda + k].  ks is read only when kScaleK.
template <bool kAKMajor, bool kScaleK>
__device__ __forceinline__ void block4x4(float acc[4][4], const float* a, int lda,
                                         const float* b, int ldb, const float* ks,
                                         int m0, int n0, int K) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4];
    if (kAKMajor) {
      const float4 t = *reinterpret_cast<const float4*>(a + k * lda + m0);
      av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = a[(m0 + r) * lda + k];
    }
    if (kScaleK) {
      const float s = ks[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] *= s;
    }
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + n0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = fmaf(av[r], bv.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], bv.y, acc[r][1]);
      acc[r][2] = fmaf(av[r], bv.z, acc[r][2]);
      acc[r][3] = fmaf(av[r], bv.w, acc[r][3]);
    }
  }
}

// out[m][n] = beta * out[m][n] (when kAccum) + rs[m] (when rs) *
//             sum_k A(m, k) ks[k] B[k][n], for an M x Nn output (both
// multiples of 4) in 4 x 4 blocks spread over the block's threads.
template <bool kAKMajor, bool kScaleK, bool kAccum>
__device__ void gemm(float* out, int ldo, float beta, const float* rs,
                     const float* a, int lda, const float* b, int ldb,
                     const float* ks, int M, int Nn, int K) {
  const int nb = Nn / 4;
  const int blocks = (M / 4) * nb;
  for (int blk = threadIdx.x; blk < blocks; blk += kThreads) {
    const int m0 = (blk / nb) * 4, n0 = (blk % nb) * 4;
    float acc[4][4];
    block4x4<kAKMajor, kScaleK>(acc, a, lda, b, ldb, ks, m0, n0, K);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = rs ? rs[m0 + r] : 1.f;
      float4* o = reinterpret_cast<float4*>(out + (m0 + r) * ldo + n0);
      float4 v = make_float4(s * acc[r][0], s * acc[r][1], s * acc[r][2], s * acc[r][3]);
      if (kAccum) {
        const float4 old = *o;
        v.x = fmaf(beta, old.x, v.x);
        v.y = fmaf(beta, old.y, v.y);
        v.z = fmaf(beta, old.z, v.z);
        v.w = fmaf(beta, old.w, v.w);
      }
      *o = v;
    }
  }
}

// Decayed scores of row tile i0 against column tile j0, stored transposed:
// at[j][i] = (c_i . b_j) exp(cum_i - cum_j) for i0 + i >= j0 + j, else 0.
// The exponent is evaluated only where it is kept (it is <= 0 there).
__device__ void scores(float* at, const float* ct, const float* bt,
                       const float* cum, int i0, int j0, int N) {
  const int m0 = (threadIdx.x / (kT / 4)) * 4;  // rows i
  const int n0 = (threadIdx.x % (kT / 4)) * 4;  // columns j
  const bool diag = i0 == j0;
  float acc[4][4];
  if (diag && n0 > m0 + 3) {  // wholly above the diagonal: no product
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  } else {
    block4x4<true, false>(acc, ct, kLdT, bt, kLdT, nullptr, m0, n0, N);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = m0 + r, j = n0 + c;
        acc[r][c] = (!diag || j <= i)
                        ? acc[r][c] * expf(cum[i0 + i] - cum[j0 + j])
                        : 0.f;
      }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(at + (n0 + c) * kLdT + m0) =
        make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
}

// dst[n][i] = src row (token) i of the tile, transposed; rows >= `rows` are
// zero.  Token i of the tile is src[(row0 + i * H) * width + n].
__device__ void load_tile_t(float* dst, const float* __restrict__ src,
                            size_t row0, int H, int width, int rows) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < kT * w4; e += kThreads) {
    const int i = e / w4, n = (e % w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows)
      v = *reinterpret_cast<const float4*>(src + (row0 + (size_t)i * H) * width + n);
    dst[(n + 0) * kLdT + i] = v.x;
    dst[(n + 1) * kLdT + i] = v.y;
    dst[(n + 2) * kLdT + i] = v.z;
    dst[(n + 3) * kLdT + i] = v.w;
  }
}

// dst[i][p] = src row (token) i of the tile; rows >= `rows` are zero.
__device__ void load_tile(float* dst, int ldd, const float* __restrict__ src,
                          size_t row0, int H, int width, int rows) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < kT * w4; e += kThreads) {
    const int i = e / w4, p = (e % w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows)
      v = *reinterpret_cast<const float4*>(src + (row0 + (size_t)i * H) * width + p);
    *reinterpret_cast<float4*>(dst + i * ldd + p) = v;
  }
}

__device__ void store_tile(float* __restrict__ dst, const float* src, int lds,
                           size_t row0, int H, int width, int rows) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < rows * w4; e += kThreads) {
    const int i = e / w4, p = (e % w4) * 4;
    *reinterpret_cast<float4*>(dst + (row0 + (size_t)i * H) * width + p) =
        *reinterpret_cast<const float4*>(src + i * lds + p);
  }
}

// Warp 0: cum[t] = da[t0] + ... + da[t0 + t] for t < Q (token t of the
// chunk at da[(row0 + t * H)]); cum[Q .. qpad) repeat cum[Q - 1], so the
// padded rows and columns of the last tile see finite exponents.
__device__ void chunk_cumsum(float* cum, const float* __restrict__ da,
                             size_t row0, int H, int Q, int qpad) {
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

__host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ size_t smem_floats(int N, int P, int Q) {
  const int ldp = P + 4;
  return (size_t)2 * N * kLdT + (size_t)kT * kLdT + (size_t)2 * kT * ldp +
         (size_t)N * ldp + round_up(Q, kT) + 2 * kT;
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ da,
           const float* __restrict__ bh, const float* __restrict__ ch,
           const float* __restrict__ h0, float* __restrict__ y,
           float* __restrict__ hout, int L, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ldp = P + 4;
  const int qpad = round_up(Q, kT);
  float* ct = smem;             // [N][kLdT]  c of the row tile, transposed
  float* bt = ct + N * kLdT;    // [N][kLdT]  b of the column tile, transposed
  float* at = bt + N * kLdT;    // [kT][kLdT] decayed scores, at[j][i]
  float* xs = at + kT * kLdT;   // [kT][ldp]  xdt of the column tile
  float* ys = xs + kT * ldp;    // [kT][ldp]  y of the row tile
  float* st = ys + kT * ldp;    // [N][ldp]   the carried state
  float* cum = st + N * ldp;    // [qpad]     cumsum of da over the chunk
  float* rs = cum + qpad;       // [kT]       exp(cum_i) of the row tile
  float* w = rs + kT;           // [kT]       exp(cum_Q - cum_j) of the column tile

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t sbase = ((size_t)b * H + h) * N * P;
  for (int e = threadIdx.x; e < N * P; e += kThreads)
    st[(e / P) * ldp + e % P] = h0[sbase + e];

  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const size_t chunk0 = (size_t)b * L + (size_t)c * Q;  // (b, first token)
    __syncthreads();  // the previous chunk is done with cum, rs, w
    if (threadIdx.x < 32) chunk_cumsum(cum, da, chunk0 * H + h, H, Q, qpad);
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      const int rows = min(kT, Q - i0);
      const bool last = it == nt - 1;
      const size_t irow = (chunk0 + i0) * H + h;
      load_tile_t(ct, ch, irow, H, N, rows);
      for (int i = threadIdx.x; i < kT; i += kThreads) rs[i] = expf(cum[i0 + i]);
      __syncthreads();
      // inter-chunk: ys = exp(cum_i) (c_i . state before the chunk)
      gemm<true, false, false>(ys, ldp, 0.f, rs, ct, kLdT, st, ldp, nullptr, kT, P, N);
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        const size_t jrow = (chunk0 + j0) * H + h;
        __syncthreads();  // bt, xs, w free; every inter product read st
        load_tile_t(bt, bh, jrow, H, N, min(kT, Q - j0));
        load_tile(xs, ldp, xdt, jrow, H, P, min(kT, Q - j0));
        if (last)
          for (int j = threadIdx.x; j < kT; j += kThreads)
            w[j] = expf(cum_last - cum[j0 + j]);
        __syncthreads();
        scores(at, ct, bt, cum, i0, j0, N);
        __syncthreads();
        // intra-chunk: ys += scores . xdt
        gemm<true, false, true>(ys, ldp, 1.f, nullptr, at, kLdT, xs, ldp, nullptr, kT, P, kT);
        if (last)  // state = state exp(cum_Q) + sum_j w_j b_j (x) xdt_j
          gemm<false, true, true>(st, ldp, jt == 0 ? expf(cum_last) : 1.f, nullptr,
                                  bt, kLdT, xs, ldp, w, N, P, kT);
      }
      __syncthreads();
      store_tile(y, ys, ldp, irow, H, P, rows);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * P; e += kThreads)
    hout[sbase + e] = st[(e / P) * ldp + e % P];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long ssd_smem_bytes(int N, int P, int Q) {
  return (long long)(smem_floats(N, P, Q) * sizeof(float));
}

// Returns the CUDA error of the launch (0 = launched).
int ssd_launch(const void* xdt, const void* da, const void* b, const void* c,
               const void* h0, void* y, void* hout, int B, int L, int H, int P,
               int N, int Q, void* stream) {
  const size_t smem = smem_floats(N, P, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(da),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hout), L, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
