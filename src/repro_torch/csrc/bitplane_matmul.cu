// Matrix product with bit-plane weights, for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/bitplane_matmul/kernel.py (bitplane_matmul, _kernel):
// x (M, K) bf16 times a weight W (K, N) stored as bit-planes, W rebuilt
// inside the kernel from its top `keep` planes (the low planes read as 0),
// float32 accumulation.  The rebuilt weight never goes back to device
// memory.
//
// Layouts (the reference's, unchanged):
//   x       (M, K)          bf16, row-major
//   planes  (bits, K, N/8)  uint8; bit i (0 = MSB) of W[k][n] sits in
//                           planes[i][k][n/8] at bit 7 - n%8; W's values
//                           are 16-bit bf16 patterns (bits <= 16)
//   out     (M, N)          float32
// Any M and K; N % 8 == 0.  (The TPU kernel needs M, K, N to be multiples
// of its 128 x 512 x 256 tiles.)
//
// What bounds it on this card: at the decode and quickstart shapes
// (M = 8 .. 128), bytes.  The weight read is keep * K * N / 8 bytes, x is
// 2 * M * K and out 4 * M * N; the product is 2 * M * K * N operations,
// which at M = 8 is ~8 operations per weight byte, far below the line.
//
// What the design does about it: one block per 32 x 64 output tile loops
// over K in steps of 32.  Each step stages the x tile (as float32) and the
// weight tile in shared memory; the weight tile is rebuilt from planes
// [0, keep) only, one thread per (row, plane byte), so planes [keep, bits)
// are never read.  Each thread accumulates a 2 x 4 sub-tile in float32
// registers with CUDA-core FMAs (bf16 x bf16 products are exact in
// float32, so only the order of the sums differs from the reference).
//
// Known limits of this first version, left for a later change: no tensor
// cores (wgmma) and no TMA; at M = 8 a 1024-wide N gives 16 blocks on 132
// SMs (no split over K); plane bytes are gathered 8 at a time per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;
constexpr int kTN = 64;
constexpr int kTK = 32;
constexpr int kThreads = 256;
constexpr int kTN8 = kTN / 8;
static_assert(kTK * kTN8 == kThreads, "one thread per (row, plane byte)");
static_assert((kTM / 2) * (kTN / 4) == kThreads, "2 x 4 outputs per thread");

__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ planes,
                       float* __restrict__ out, int M, int K, int N, int bits,
                       int keep) {
  __shared__ float xs[kTK][kTM + 1];  // padded: transposed stores hit 32 banks
  __shared__ __align__(16) float ws[kTK][kTN];
  const int n8 = N / 8;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int row = (tid / (kTN / 4)) * 2;  // this thread's two output rows
  const int col = (tid % (kTN / 4)) * 4;  // and four output columns
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      const int r = e / kTK, c = e % kTK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? __bfloat162float(x[(size_t)gm * K + gk])
                     : 0.f;
    }
    {
      const int r = tid / kTN8, b = tid % kTN8;
      const int gk = k0 + r, gb = n0 / 8 + b;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (gk < K && gb < n8) {
        for (int i = 0; i < keep; ++i) {
          const uint32_t byte = planes[((size_t)i * K + gk) * n8 + gb];
          const int shift = bits - 1 - i;
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] |= ((byte >> (7 - k)) & 1u) << shift;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[r][b * 8 + k] = __uint_as_float(v[k] << 16);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float a0 = xs[kk][row], a1 = xs[kk][row + 1];
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][col]);
      acc[0][0] = fmaf(a0, w.x, acc[0][0]);
      acc[0][1] = fmaf(a0, w.y, acc[0][1]);
      acc[0][2] = fmaf(a0, w.z, acc[0][2]);
      acc[0][3] = fmaf(a0, w.w, acc[0][3]);
      acc[1][0] = fmaf(a1, w.x, acc[1][0]);
      acc[1][1] = fmaf(a1, w.y, acc[1][1]);
      acc[1][2] = fmaf(a1, w.z, acc[1][2]);
      acc[1][3] = fmaf(a1, w.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = m0 + row + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + col + c;
      if (gn < N) out[(size_t)gm * N + gn] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int bitplane_matmul_launch(const void* x, const void* planes, void* out, int M,
                           int K, int N, int bits, int keep, void* stream) {
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  bitplane_matmul_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(planes), static_cast<float*>(out), M, K, N,
      bits, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
