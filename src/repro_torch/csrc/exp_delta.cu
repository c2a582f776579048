// Exponent-delta encode and decode, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/exp_delta/kernel.py:
//   * encode (_encode_kernel): per row of G raw values, subtract the row's
//     smallest exponent field from every value's exponent field and emit
//     that minimum as the row's base (the paper's eq. 6-7, Fig. 6 (3));
//   * decode (_decode_kernel): add the base back, modulo the field width.
//
// Layout:
//   u, enc  (R, G)  raw bits, 1, 2 or 4 bytes each (uint8, 16- or 32-bit
//                   containers), row-major; a row is one channel of one
//                   16-token group of the clustered KV page (G <= 32)
//   base    (R,)    uint8
// The TPU kernel tiles 256 channels per grid step and pads the channel
// count to that tile; these kernels take any R and pad nothing.
//
// What bounds them on this card: bytes.  Each reads R * G * width bytes
// and writes as many, plus R bytes of bases, with a few integer operations
// per value, far below the H100's ~300 operations per byte.
//
// What the design does about it: one thread per row, rows taken by a
// grid-stride loop.  A row is held in registers: the min needs every value
// of the row before the first store.  At the store's G = 16 a row is a
// whole number of 16-byte vectors (bf16: 32 bytes, two vectors) and moves
// as vectors; any other G moves value by value.  Values widen to uint32_t before any shift, so the 16-bit
// patterns that ride in a signed container never sign-extend.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 32;
constexpr int kMaxBlocks = 4096;

// The g values of one row into v[0, g): as 16-byte vectors when the row
// length kG is known here (a whole number of vectors at every width; the
// launcher checks the alignment), else one by one.
template <typename T, int kG>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         uint32_t (&v)[kMaxG], int g) {
  constexpr int kBytes = kG * (int)sizeof(T);
  static_assert(kBytes % 16 == 0, "a fixed row is whole 16-byte vectors");
  if constexpr (kG > 0) {
    constexpr int kVec = kBytes / 16;
    union {
      uint4 q[kVec];
      T e[kG];
    } buf;
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kVec; ++i) buf.q[i] = s[i];
#pragma unroll
    for (int k = 0; k < kG; ++k) v[k] = (uint32_t)buf.e[k];
  } else {
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g) v[k] = (uint32_t)src[k];
  }
}

template <typename T, int kG>
__device__ __forceinline__ void store_row(T* __restrict__ dst,
                                          const uint32_t (&v)[kMaxG], int g) {
  constexpr int kBytes = kG * (int)sizeof(T);
  static_assert(kBytes % 16 == 0, "a fixed row is whole 16-byte vectors");
  if constexpr (kG > 0) {
    constexpr int kVec = kBytes / 16;
    union {
      uint4 q[kVec];
      T e[kG];
    } buf;
#pragma unroll
    for (int k = 0; k < kG; ++k) buf.e[k] = (T)v[k];
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < kVec; ++i) d[i] = buf.q[i];
  } else {
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g) dst[k] = (T)v[k];
  }
}

// kG > 0: the row length, fixed at compile time; kG == 0: g_rt at run time.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
exp_delta_encode_kernel(const T* __restrict__ u, T* __restrict__ enc,
                        uint8_t* __restrict__ base, int64_t rows, int g_rt,
                        int man_bits, uint32_t exp_mask) {
  const int g = kG > 0 ? kG : g_rt;
  const uint32_t field = exp_mask << man_bits;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * kThreads) {
    uint32_t v[kMaxG];
    load_row<T, kG>(u + r * g, v, g);
    uint32_t lo = exp_mask;
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g) lo = min(lo, (v[k] >> man_bits) & exp_mask);
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g)
        v[k] = (v[k] & ~field) | ((((v[k] >> man_bits) & exp_mask) - lo) << man_bits);
    store_row<T, kG>(enc + r * g, v, g);
    base[r] = (uint8_t)lo;
  }
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
exp_delta_decode_kernel(const T* __restrict__ enc,
                        const uint8_t* __restrict__ base, T* __restrict__ u,
                        int64_t rows, int g_rt, int man_bits,
                        uint32_t exp_mask) {
  const int g = kG > 0 ? kG : g_rt;
  const uint32_t field = exp_mask << man_bits;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * kThreads) {
    uint32_t v[kMaxG];
    load_row<T, kG>(enc + r * g, v, g);
    const uint32_t b = base[r];
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g)
        v[k] = (v[k] & ~field) |
               (((((v[k] >> man_bits) & exp_mask) + b) & exp_mask) << man_bits);
    store_row<T, kG>(u + r * g, v, g);
  }
}

bool misaligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) != 0;
}

int blocks_for(int64_t rows) {
  const int64_t n = (rows + kThreads - 1) / kThreads;
  return (int)(n < kMaxBlocks ? (n > 0 ? n : 1) : kMaxBlocks);
}

// The store's row length (G = 16) is fixed at compile time, so its rows move
// as 16-byte vectors (the binding passes 16-byte aligned pointers); any
// other g <= 32 is read at run time and moves value by value.
#define EXP_DELTA_DISPATCH(KERNEL, ...)                               \
  do {                                                                \
    if (g == 16)                                                      \
      KERNEL<T, 16><<<grid, kThreads, 0, s>>>(__VA_ARGS__);           \
    else                                                              \
      KERNEL<T, 0><<<grid, kThreads, 0, s>>>(__VA_ARGS__);            \
  } while (0)

template <typename T>
int encode(const void* u, void* enc, void* base, int64_t rows, int g,
           int man_bits, uint32_t exp_mask, cudaStream_t s) {
  const int grid = blocks_for(rows);
  const T* ut = static_cast<const T*>(u);
  T* et = static_cast<T*>(enc);
  uint8_t* bt = static_cast<uint8_t*>(base);
  EXP_DELTA_DISPATCH(exp_delta_encode_kernel, ut, et, bt, rows, g, man_bits,
                     exp_mask);
  return (int)cudaGetLastError();
}

template <typename T>
int decode(const void* enc, const void* base, void* u, int64_t rows, int g,
           int man_bits, uint32_t exp_mask, cudaStream_t s) {
  const int grid = blocks_for(rows);
  const T* et = static_cast<const T*>(enc);
  const uint8_t* bt = static_cast<const uint8_t*>(base);
  T* ut = static_cast<T*>(u);
  EXP_DELTA_DISPATCH(exp_delta_decode_kernel, et, bt, ut, rows, g, man_bits,
                     exp_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width other than 1, 2 or 4 bytes, a row
// length outside [1, 32] or, at g == 16, a pointer that is not 16-byte
// aligned.  rows == 0 launches nothing and returns 0.

int exp_delta_encode_launch(const void* u, void* enc, void* base,
                            long long rows, int g, int width, int man_bits,
                            int exp_mask, void* stream) {
  if (g < 1 || g > kMaxG || (g == 16 && misaligned(u, enc)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (uint32_t)exp_mask;
  switch (width) {
    case 1: return encode<uint8_t>(u, enc, base, rows, g, man_bits, mask, s);
    case 2: return encode<uint16_t>(u, enc, base, rows, g, man_bits, mask, s);
    case 4: return encode<uint32_t>(u, enc, base, rows, g, man_bits, mask, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int exp_delta_decode_launch(const void* enc, const void* base, void* u,
                            long long rows, int g, int width, int man_bits,
                            int exp_mask, void* stream) {
  if (g < 1 || g > kMaxG || (g == 16 && misaligned(enc, u)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (uint32_t)exp_mask;
  switch (width) {
    case 1: return decode<uint8_t>(enc, base, u, rows, g, man_bits, mask, s);
    case 2: return decode<uint16_t>(enc, base, u, rows, g, man_bits, mask, s);
    case 4: return decode<uint32_t>(enc, base, u, rows, g, man_bits, mask, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
