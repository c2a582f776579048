// Bit-plane pack and unpack, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/bitplane/kernel.py:
//   * pack (_pack_kernel): values -> bit-planes, a bit-matrix transpose;
//   * unpack (_unpack_kernel): bit-planes -> values from the top `keep`
//     planes only, the low planes zero (the partial-plane fetch).
//
// Layout (the reference's, unchanged):
//   values  (m,)          raw bits, 1, 2 or 4 bytes each (uint8, 16- or
//                         32-bit containers), m % 8 == 0
//   planes  (bits, m/8)   uint8; plane i holds bit (bits - 1 - i) of every
//                         value (plane 0 = MSB); byte j of a plane covers
//                         values 8j .. 8j+7, value 8j at bit 7
// There is no block padding: the TPU kernel tiles 4096-byte plane blocks,
// these kernels take any m that is a multiple of 8.
//
// What bounds them on this card: bytes.  pack reads m * width bytes and
// writes bits * m / 8; unpack reads keep * m / 8 (planes [keep, bits) are
// never touched) and writes m * width.  They do a few integer operations
// per bit, far below the H100's ~300 operations per byte.
//
// What the design does about it: one thread per octet of values (eight
// consecutive values, one byte of every plane).  Consecutive threads take
// consecutive octets, so each plane row is read or written by a warp as 32
// consecutive bytes, and the values as 8 * width consecutive bytes per
// thread.  Nothing is staged in shared memory: each byte is read once.
//
// Known limit of this first version, left for a later change: the value
// side is moved one element at a time, not as 16-byte vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ u, uint8_t* __restrict__ planes,
            int64_t m8, int bits) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= m8) return;
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (uint32_t)u[j * 8 + k];
  for (int i = 0; i < bits; ++i) {
    const int shift = bits - 1 - i;
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) byte |= ((v[k] >> shift) & 1u) << (7 - k);
    planes[(int64_t)i * m8 + j] = (uint8_t)byte;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ planes, T* __restrict__ u,
              int64_t m8, int bits, int keep) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= m8) return;
  uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < keep; ++i) {
    const uint32_t byte = planes[(int64_t)i * m8 + j];
    const int shift = bits - 1 - i;
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] |= ((byte >> (7 - k)) & 1u) << shift;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) u[j * 8 + k] = (T)v[k];
}

int blocks_for(int64_t m8) { return (int)((m8 + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width other than 1, 2 or 4 bytes.

int bitplane_pack_launch(const void* u, void* planes, long long m8, int width,
                         int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* p = static_cast<uint8_t*>(planes);
  const int grid = blocks_for(m8);
  switch (width) {
    case 1:
      pack_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(u), p,
                                            m8, bits);
      break;
    case 2:
      pack_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint16_t*>(u), p,
                                            m8, bits);
      break;
    case 4:
      pack_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(u), p,
                                            m8, bits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bitplane_unpack_launch(const void* planes, void* u, long long m8,
                           int width, int bits, int keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(planes);
  const int grid = blocks_for(m8);
  switch (width) {
    case 1:
      unpack_kernel<<<grid, kThreads, 0, s>>>(p, static_cast<uint8_t*>(u), m8,
                                              bits, keep);
      break;
    case 2:
      unpack_kernel<<<grid, kThreads, 0, s>>>(p, static_cast<uint16_t*>(u), m8,
                                              bits, keep);
      break;
    case 4:
      unpack_kernel<<<grid, kThreads, 0, s>>>(p, static_cast<uint32_t*>(u), m8,
                                              bits, keep);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
