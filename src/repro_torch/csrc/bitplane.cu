// Bit-plane pack and unpack, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/bitplane/kernel.py:
//   * pack (_pack_kernel): values -> bit-planes, a bit-matrix transpose;
//   * unpack (_unpack_kernel): bit-planes -> values from the top `keep`
//     planes only, the low planes zero (the partial-plane fetch).
//
// Layout (the reference's, unchanged):
//   values  raw bits, 1, 2 or 4 bytes each (uint8, 16- or 32-bit
//           containers), in rows of 8 * r8 values
//   planes  uint8; plane i holds bit (bits - 1 - i) of every value (plane 0
//           = MSB); byte j of a plane row covers values 8j .. 8j+7 of the
//           row, value 8j at bit 7
// One launch walks the rows of one or two streams (K and V).  Row (a, b)
// of a stream's planes starts at a * sa + b * sb bytes and holds r8
// contiguous bytes of each plane, plane i at i * ps further on; the values
// are dense rows.  The flat entry points are one stream of one row of m/8
// bytes (plane stride m/8).  The KV cache is (bits, B, S, Hkv, hd/8): rows
// (batch row, position) of Hkv * hd / 8 bytes.  Pack writes straight into
// it: row (a, b) of the values lands at position start + b, where start is
// a host integer (a prefill chunk) or clamp(start[a], 0, s_max) read here
// on the device (a decode token), so no plane tensor, index_put or copy
// follows, and the host never reads start.
//
// What bounds them on this card: bytes at large m (pack reads m * width
// and writes bits * m / 8; unpack reads keep * m / 8, never touching planes
// [keep, bits), and writes m * width), and the launch and one thread's chain
// of dependent loads, transposes and stores at the shapes the serving path
// gives them (a decode token's K and V rows are 12 KB moved; chip_smoke.py
// phase 6 prints each shape's byte bound beside an empty kernel's time).
//
// What the design does about it:
//   * the launch: K and V in one launch, written in place (a decode step
//     made two packs and two index_put kernels a layer, a prefill chunk two
//     unpacks, two packs and two slice copies);
//   * bytes: a thread takes four octets of a row (32 values) and one 4-byte
//     word of each plane, so a warp moves a plane row in whole 128-byte
//     lines; values move as 16-byte vectors (an octet of bf16 is exactly
//     16 bytes; 8 bytes at width 1, two vectors at width 4).  A row whose
//     r8 is no multiple of 4 ends in a partial word, and planes whose
//     strides or address are not 4-byte aligned, in bytes.  unpack issues
//     every kept plane's load before it uses any; the grid is a grid-stride
//     loop of 64-thread blocks, up to 32 an SM;
//   * operations: the bit transpose runs in registers, not one
//     shift-and-or per bit: per octet and byte of the values, an 8 x 8
//     bit-matrix transpose on a 64-bit word (three masked delta swaps),
//     and a 4 x 4 byte transpose (__byte_perm) between four octets and
//     four plane words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBlocks = 132 * 32;

// Rows of the launch.  A unit is (stream, row, quad): four octets of a row
// (fewer at a row's ragged end), one plane word.
struct Rows {
  uint32_t n_b;         // rows per outer index a
  uint32_t r8;          // plane bytes (octets of values) of a row
  uint32_t quads;       // units a row: ceil(r8 / 4)
  uint32_t per_stream;  // units a stream
  uint32_t units;       // units of the launch
  int64_t ps, sa, sb;   // plane, outer-row and inner-row strides of the planes
  int words;            // plane rows are 4-byte aligned: whole-word access
};

struct Args {
  const uint8_t* src0;
  const uint8_t* src1;
  uint8_t* dst0;
  uint8_t* dst1;
  Rows rows;
  int bits;
  int keep;               // unpack: planes [0, keep) are read
  const int32_t* start;   // pack: per outer row a, clamped to [0, s_max]
  int64_t start0;         // pack: the host's start when start is null
  int32_t s_max;
};

// An 8 x 8 bit-matrix transpose: bit 8r + c moves to bit 8c + r.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// A 4 x 4 byte transpose: byte n of o[k] is byte k of a[n].
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* o) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (uint64_t)hi << 32 | lo;
}

// The 8 x 8 bit matrix of byte j of an octet's values, a row a byte: byte
// r of the result is byte j of value 7 - r, so that, transposed, value k
// lands on bit 7 - k of each plane byte.  w holds the octet's 8 * W bytes
// as 2 * W little-endian words.
template <int W>
__device__ __forceinline__ uint64_t rows_of(const uint32_t* w, int j);

template <>
__device__ __forceinline__ uint64_t rows_of<1>(const uint32_t* w, int) {
  return join(__byte_perm(w[1], 0, 0x0123), __byte_perm(w[0], 0, 0x0123));
}

template <>
__device__ __forceinline__ uint64_t rows_of<2>(const uint32_t* w, int j) {
  const uint32_t sel = j ? 0x1357 : 0x0246;
  return join(__byte_perm(w[2], w[3], sel), __byte_perm(w[0], w[1], sel));
}

template <>
__device__ __forceinline__ uint64_t rows_of<4>(const uint32_t* w, int j) {
  const uint32_t sel = (4 + j) | (j << 4);  // byte j of the second, then the first
  return join(__byte_perm(__byte_perm(w[6], w[7], sel), __byte_perm(w[4], w[5], sel), 0x5410),
              __byte_perm(__byte_perm(w[2], w[3], sel), __byte_perm(w[0], w[1], sel), 0x5410));
}

// The inverse: the octet's words w from its W row matrices x (x[j] as
// rows_of(w, j) would give it).
template <int W>
__device__ __forceinline__ void from_rows(const uint64_t* x, uint32_t* w);

template <>
__device__ __forceinline__ void from_rows<1>(const uint64_t* x, uint32_t* w) {
  w[1] = __byte_perm((uint32_t)x[0], 0, 0x0123);
  w[0] = __byte_perm((uint32_t)(x[0] >> 32), 0, 0x0123);
}

template <>
__device__ __forceinline__ void from_rows<2>(const uint64_t* x, uint32_t* w) {
  const uint32_t l0 = (uint32_t)x[0], l1 = (uint32_t)x[1];
  const uint32_t h0 = (uint32_t)(x[0] >> 32), h1 = (uint32_t)(x[1] >> 32);
  w[3] = __byte_perm(l0, l1, 0x4051);
  w[2] = __byte_perm(l0, l1, 0x6273);
  w[1] = __byte_perm(h0, h1, 0x4051);
  w[0] = __byte_perm(h0, h1, 0x6273);
}

template <>
__device__ __forceinline__ void from_rows<4>(const uint64_t* x, uint32_t* w) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int shift = v < 4 ? 32 : 0;
    const uint32_t p = v < 4 ? 3 - v : 7 - v;  // value v's byte in its half
    const uint32_t sel = p | ((4 + p) << 4);
    const uint32_t a = __byte_perm((uint32_t)(x[0] >> shift), (uint32_t)(x[1] >> shift), sel);
    const uint32_t b = __byte_perm((uint32_t)(x[2] >> shift), (uint32_t)(x[3] >> shift), sel);
    w[v] = __byte_perm(a, b, 0x5410);
  }
}

template <int W>
__device__ __forceinline__ void load_octet(const uint8_t* p, uint32_t* w) {
  if constexpr (W == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < W / 2; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * h);
      w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z, w[4 * h + 3] = v.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_octet(uint8_t* p, const uint32_t* w) {
  if constexpr (W == 1) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int h = 0; h < W / 2; ++h)
      *reinterpret_cast<uint4*>(p + 16 * h) =
          make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
  }
}

// A unit's place: its stream, row (a, b) and quad, and the octets it holds.
struct Unit {
  uint32_t stream, row, a, b, quad;
  int octets;
};

__device__ __forceinline__ Unit locate(const Rows& r, uint32_t u) {
  Unit x;
  x.stream = u / r.per_stream;
  const uint32_t rem = u - x.stream * r.per_stream;
  x.row = rem / r.quads;
  x.quad = rem - x.row * r.quads;
  x.a = x.row / r.n_b;
  x.b = x.row - x.a * r.n_b;
  x.octets = (int)min(4u, r.r8 - 4 * x.quad);
  return x;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
bitplane_pack_kernel(const Args args) {
  const Rows& r = args.rows;
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < r.units;
       u += gridDim.x * kThreads) {
    const Unit x = locate(r, u);
    const uint8_t* src = (x.stream ? args.src1 : args.src0) +
                         ((int64_t)x.row * r.r8 + 4 * x.quad) * 8 * W;
    const int64_t pos = x.b + (args.start != nullptr
                                   ? min(max(args.start[x.a], 0), args.s_max)
                                   : args.start0);
    uint8_t* dst = (x.stream ? args.dst1 : args.dst0) + x.a * r.sa + pos * r.sb +
                   4 * x.quad;
    uint32_t w[4][2 * W];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (o < x.octets) {
        load_octet<W>(src + o * 8 * W, w[o]);
      } else {
#pragma unroll
        for (int k = 0; k < 2 * W; ++k) w[o][k] = 0;
      }
    }
    // pw[q]: byte o is octet o's plane byte of bit q
    uint32_t pw[8 * W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const uint64_t t = transpose8(rows_of<W>(w[o], j));
        lo[o] = (uint32_t)t, hi[o] = (uint32_t)(t >> 32);
      }
      transpose4(lo, &pw[8 * j]);
      transpose4(hi, &pw[8 * j + 4]);
    }
    const bool whole = r.words && x.octets == 4;
#pragma unroll
    for (int q = 0; q < 8 * W; ++q) {
      if (q < args.bits) {
        uint8_t* p = dst + (int64_t)(args.bits - 1 - q) * r.ps;
        if (whole) {
          *reinterpret_cast<uint32_t*>(p) = pw[q];
        } else {
          for (int o = 0; o < x.octets; ++o) p[o] = (uint8_t)(pw[q] >> (8 * o));
        }
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
bitplane_unpack_kernel(const Args args) {
  const Rows& r = args.rows;
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < r.units;
       u += gridDim.x * kThreads) {
    const Unit x = locate(r, u);
    const uint8_t* src = (x.stream ? args.src1 : args.src0) + x.a * r.sa + x.b * r.sb +
                         4 * x.quad;
    const bool whole = r.words && x.octets == 4;
    // every kept plane's load first; planes [keep, bits) read as zero
    uint32_t pw[8 * W];
#pragma unroll
    for (int q = 0; q < 8 * W; ++q) {
      const int plane = args.bits - 1 - q;
      uint32_t v = 0;
      if (q < args.bits && plane < args.keep) {
        const uint8_t* p = src + (int64_t)plane * r.ps;
        if (whole) {
          v = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          for (int o = 0; o < x.octets; ++o) v |= (uint32_t)__ldg(p + o) << (8 * o);
        }
      }
      pw[q] = v;
    }
    uint64_t rows[4][W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint32_t lo[4], hi[4];
      transpose4(&pw[8 * j], lo);
      transpose4(&pw[8 * j + 4], hi);
#pragma unroll
      for (int o = 0; o < 4; ++o) rows[o][j] = transpose8(join(lo[o], hi[o]));
    }
    uint8_t* dst = (x.stream ? args.dst1 : args.dst0) +
                   ((int64_t)x.row * r.r8 + 4 * x.quad) * 8 * W;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (o < x.octets) {
        uint32_t w[2 * W];
        from_rows<W>(rows[o], w);
        store_octet<W>(dst + o * 8 * W, w);
      }
    }
  }
}

__global__ void bitplane_empty_kernel() {}

// The launch's rows, or false when they are out of range.
bool make_rows(int streams, long long n_a, long long n_b, long long r8, long long ps,
               long long sa, long long sb, const void* p0, const void* p1, Rows* r) {
  if (streams < 1 || streams > 2 || n_a <= 0 || n_b <= 0 || r8 <= 0 || r8 > 0x7fffffffLL)
    return false;
  const long long quads = (r8 + 3) / 4;
  const long long per_stream = n_a * n_b * quads;
  if (n_a > 0x7fffffffLL || n_b > 0x7fffffffLL || per_stream * streams >= (1LL << 31))
    return false;
  r->n_b = (uint32_t)n_b;
  r->r8 = (uint32_t)r8;
  r->quads = (uint32_t)quads;
  r->per_stream = (uint32_t)per_stream;
  r->units = (uint32_t)(per_stream * streams);
  r->ps = ps, r->sa = sa, r->sb = sb;
  uintptr_t bits = (uintptr_t)p0 | (uintptr_t)ps | (uintptr_t)sa | (uintptr_t)sb;
  if (streams == 2) bits |= (uintptr_t)p1;
  r->words = (bits & 3) == 0;
  return true;
}

int grid_for(uint32_t units) {
  const uint32_t blocks = (units + kThreads - 1) / kThreads;
  return (int)(blocks < (uint32_t)kMaxBlocks ? blocks : (uint32_t)kMaxBlocks);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width other than 1, 2 or 4 bytes or rows out
// of range.  Strides are in bytes; src1/dst1 are read only when streams is 2.

// Values (streams, n_a, n_b, 8 * r8) dense -> planes of each stream, row
// (a, b) at a * sa + (pos + b) * sb, pos = clamp(start[a], 0, s_max) when
// start is given, else start0.
int bitplane_pack_launch(const void* src0, const void* src1, void* dst0, void* dst1,
                         int streams, long long n_a, long long n_b, long long r8,
                         long long ps, long long sa, long long sb, int width, int bits,
                         const void* start, long long start0, long long s_max,
                         void* stream) {
  Args a{};
  if (!make_rows(streams, n_a, n_b, r8, ps, sa, sb, dst0, dst1, &a.rows) || bits < 1 ||
      bits > 8 * width)
    return (int)cudaErrorInvalidValue;
  a.src0 = static_cast<const uint8_t*>(src0);
  a.src1 = static_cast<const uint8_t*>(src1);
  a.dst0 = static_cast<uint8_t*>(dst0);
  a.dst1 = static_cast<uint8_t*>(dst1);
  a.bits = bits;
  a.keep = bits;
  a.start = static_cast<const int32_t*>(start);
  a.start0 = start0;
  a.s_max = (int32_t)s_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(a.rows.units);
  switch (width) {
    case 1: bitplane_pack_kernel<1><<<grid, kThreads, 0, s>>>(a); break;
    case 2: bitplane_pack_kernel<2><<<grid, kThreads, 0, s>>>(a); break;
    case 4: bitplane_pack_kernel<4><<<grid, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Planes of each stream, row (a, b) at a * sa + b * sb, planes [0, keep)
// read -> values (streams, n_a, n_b, 8 * r8) dense, dst1 the second
// stream's.
int bitplane_unpack_launch(const void* src0, const void* src1, void* dst0, void* dst1,
                           int streams, long long n_a, long long n_b, long long r8,
                           long long ps, long long sa, long long sb, int width, int bits,
                           int keep, void* stream) {
  Args a{};
  if (!make_rows(streams, n_a, n_b, r8, ps, sa, sb, src0, src1, &a.rows) || bits < 1 ||
      bits > 8 * width || keep < 0 || keep > bits)
    return (int)cudaErrorInvalidValue;
  a.src0 = static_cast<const uint8_t*>(src0);
  a.src1 = static_cast<const uint8_t*>(src1);
  a.dst0 = static_cast<uint8_t*>(dst0);
  a.dst1 = static_cast<uint8_t*>(dst1);
  a.bits = bits;
  a.keep = keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(a.rows.units);
  switch (width) {
    case 1: bitplane_unpack_kernel<1><<<grid, kThreads, 0, s>>>(a); break;
    case 2: bitplane_unpack_kernel<2><<<grid, kThreads, 0, s>>>(a); break;
    case 4: bitplane_unpack_kernel<4><<<grid, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An empty kernel: its device time is the launch floor that phase 6 of
// chip_smoke.py prints beside the bounds.  No wrapper counts it.
int bitplane_empty_launch(void* stream) {
  bitplane_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
