// Exponent-delta encode and decode, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/exp_delta/kernel.py:
//   * encode (_encode_kernel): per row of G raw values, subtract the row's
//     smallest exponent field from every value's exponent field and emit
//     that minimum as the row's base (the paper's eq. 6-7, Fig. 6 (3));
//   * decode (_decode_kernel): add the base back, modulo the field width.
//
// The encode also does the transform's two steps around it.  The store
// clusters a KV span before it encodes (src/repro/core/kv_clustering.py
// cluster_and_encode_np: token-major (tokens, channels) -> channel-major
// groups (channels, G)) and pads a ragged tail group by repeating the last
// token (compressed_store.py).  This kernel reads the raw bits where the
// caller holds them and writes the channel-major result, so nothing is
// copied between the caller's unpack and its bit-plane pack.
//
// Layout of the encode:
//   u     (..., t, C) raw bits, 1, 2 or 4 bytes each (uint8, 16- or 32-bit
//         containers): channel stride 1, token stride st and up to three
//         leading dims of any strides (values).  Each leading index holds
//         n_pages = ceil(t / G) pages of G tokens; token j of page p is
//         min(p * G + j, t - 1), so a ragged tail repeats token t - 1.
//   enc   (..., n_pages, C, G) contiguous: unit (page, channel) is a row of
//         G values, pages in row-major order of the leading dims
//   base  (..., n_pages, C) uint8
// The TPU kernel's own contract, (R, G) channel-major rows, is the view
// (R, G, 1) of this one: R leading indices of G tokens of one channel, one
// page each.  The decode keeps the rows: enc, u (R, G) rows, base (R,)
// uint8.  The TPU kernel tiles 256 channels per grid step and pads the
// channel count to that tile; these kernels take any R and pad nothing.
// G <= 32.
//
// What bounds them on this card: bytes.  Each reads the values once and
// writes as many, plus a byte of base per G values, with a few integer
// operations per value, far below the H100's ~300 operations per byte.
// At the serving path's shapes (a 512-token span is 1.5 MB, a decode page
// fill 48 KB) the launch and one load-to-store chain per thread set the
// time.
//
// What the encode's design does about it: a block takes a tile of whole
// pages (tile_pages * C <= 256 units) or a 256-channel chunk of one page.
// Its threads first stage the tile's token rows in shared memory, every
// load issued before any is used: 16-byte vectors along the channels,
// neighbouring threads on neighbouring addresses (a warp reads 512
// contiguous bytes of a row; a bf16 row of 192 channels is 384 bytes)
// when the rows are whole aligned vectors, value by value otherwise (the
// byte path: unaligned pointer or strides, C * width no multiple of 16).
// Then one thread per (page, channel) unit reads its G values down a
// column of the tile (neighbouring threads on neighbouring values: no bank
// conflict), takes the min in registers and stores its encoded row as
// 16-byte vectors (at G = 16 a warp's 32 rows are 1 KB contiguous) and its
// base.  A block of 192 threads stages 6 KB at the serving width; up to
// eight such blocks share an SM.  The page's first row, and the last real
// token of its tail, are computed once per page per block (integer
// divisions over the leading dims), not per load.
//
// Pages of one channel whose tokens are contiguous and whole groups (the
// flat rows above among them) need no transpose: a unit's G values lie
// side by side, so its thread loads them itself (16-byte vectors at G =
// 16, where the launcher checks the alignment), takes the min and stores
// its row, with no staging and no barrier (the direct path, its own
// instantiation of the kernel).
//
// At G = 16, fixed at compile time, rows move as vectors; any other G <=
// 32 is read at run time and moves value by value.  Values widen to
// uint32_t before any shift, so the 16-bit patterns that ride in a signed
// container never sign-extend.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 32;
constexpr int kMaxBlocks = 4096;
// a tile's staged rows, at most (the launcher refuses more)
constexpr int kMaxTileBytes = 32 * 1024;
// how the encode reads its input: staged value by value, staged as 16-byte
// vectors, or a unit's contiguous row loaded by its own thread
constexpr int kPathBytes = 0, kPathVec = 1, kPathDirect = 2;

// The addressing of the encode's input and its tile plan.
struct Geometry {
  unsigned n1, n2;          // the two inner leading dims (1 where absent)
  long long s0, s1, s2;     // the three leading dims' strides, in values
  long long t, st;          // tokens and the token stride, in values
  unsigned n_pages;         // pages of a leading index: ceil(t / g)
  unsigned pages;           // pages in all
  int c;                    // channels, stride 1
  int tile_pages;           // pages of a tile (1 when a page is cut)
  int chunk;                // channels of a tile
  int chunks;               // tiles across a page's channels
  int row_bytes;            // a staged row's stride in shared memory
  int path;                 // kPathBytes, kPathVec or kPathDirect
};

// The offset (values) of page p's first token, and in last the index in the
// page of its last real token (tokens past it repeat it).
__device__ __forceinline__ long long page_origin(const Geometry& q, unsigned p, int g,
                                                 int& last) {
  unsigned lead = 0, pp = p;
  long long off = 0;
  if (q.n_pages != q.pages) {
    lead = p / q.n_pages;
    pp = p - lead * q.n_pages;
    const unsigned i2 = lead % q.n2, rest = lead / q.n2;
    const unsigned i1 = rest % q.n1, i0 = rest / q.n1;
    off = i0 * q.s0 + i1 * q.s1 + i2 * q.s2;
  }
  const long long first = (long long)pp * g;
  last = (int)min((long long)g - 1, q.t - 1 - first);
  return off + first * q.st;
}

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

// Encode the g values of v in place, store them at dst and their base.
template <typename T, int kG>
__device__ __forceinline__ void encode_row(uint32_t (&v)[kMaxG], int g, int man_bits,
                                           uint32_t exp_mask, T* __restrict__ dst,
                                           uint8_t* __restrict__ base) {
  const uint32_t field = exp_mask << man_bits;
  uint32_t lo = exp_mask;
#pragma unroll
  for (int k = 0; k < kMaxG; ++k)
    if (k < g) lo = min(lo, (v[k] >> man_bits) & exp_mask);
#pragma unroll
  for (int k = 0; k < kMaxG; ++k)
    if (k < g)
      v[k] = (v[k] & ~field) | ((((v[k] >> man_bits) & exp_mask) - lo) << man_bits);
  store_row<T, kG>(dst, v, g);
  *base = (uint8_t)lo;
}

// kG > 0: the group length, fixed at compile time; kG == 0: g_rt at run time.
// kDirect: the direct path, compiled apart (a run-time branch to it inside
// the staged kernel slowed the staged path on an H100).
template <typename T, int kG, bool kDirect>
__global__ void __launch_bounds__(kThreads)
exp_delta_encode_kernel(const T* __restrict__ u, T* __restrict__ enc,
                        uint8_t* __restrict__ base, const Geometry q, int g_rt,
                        int man_bits, uint32_t exp_mask) {
  const int g = kG > 0 ? kG : g_rt;
  if constexpr (kDirect) {  // one channel, whole groups of contiguous tokens
    const unsigned p = blockIdx.x * q.tile_pages + threadIdx.x;
    if ((int)threadIdx.x < q.tile_pages && p < q.pages) {
      int last;
      uint32_t v[kMaxG];
      load_row<T, kG>(u + page_origin(q, p, g, last), v, g);
      encode_row<T, kG>(v, g, man_bits, exp_mask, enc + (long long)p * g, base + p);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char tile[];
  __shared__ long long origin[kThreads];
  __shared__ int last_tok[kThreads];
  const unsigned chunk = blockIdx.x % q.chunks;
  const unsigned p0 = blockIdx.x / q.chunks * q.tile_pages;
  const int np = (int)min((unsigned)q.tile_pages, q.pages - p0);
  const int c0 = (int)chunk * q.chunk;
  const int cw = min(q.chunk, q.c - c0);
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    origin[i] = page_origin(q, p0 + i, g, last_tok[i]) + c0;
  __syncthreads();
  // stage the tile's token rows
  const int rows = np * g;
  if (q.path == kPathVec) {
    constexpr int kPerVec = 16 / (int)sizeof(T);
    const int vr = cw / kPerVec;
    for (int i = threadIdx.x; i < rows * vr; i += blockDim.x) {
      const int r = i / vr, x = i - r * vr;
      const int pl = r / g, j = r - pl * g;
      const T* src = u + origin[pl] + min(j, last_tok[pl]) * q.st;
      reinterpret_cast<uint4*>(tile + r * q.row_bytes)[x] =
          reinterpret_cast<const uint4*>(src)[x];
    }
  } else {
    for (int i = threadIdx.x; i < rows * cw; i += blockDim.x) {
      const int r = i / cw, x = i - r * cw;
      const int pl = r / g, j = r - pl * g;
      reinterpret_cast<T*>(tile + r * q.row_bytes)[x] =
          u[origin[pl] + min(j, last_tok[pl]) * q.st + x];
    }
  }
  __syncthreads();
  // a thread per (page, channel) unit
  const int i = threadIdx.x;
  if (i < np * cw) {
    const int pl = i / cw, x = i - pl * cw;
    const unsigned char* col = tile + pl * g * q.row_bytes + x * (int)sizeof(T);
    uint32_t v[kMaxG];
#pragma unroll
    for (int k = 0; k < kMaxG; ++k)
      if (k < g) v[k] = (uint32_t)*reinterpret_cast<const T*>(col + k * q.row_bytes);
    const long long unit = (long long)(p0 + pl) * q.c + c0 + x;
    encode_row<T, kG>(v, g, man_bits, exp_mask, enc + unit * g, base + unit);
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

// The store's group length (G = 16) is fixed at compile time, so its rows
// move as 16-byte vectors; any other g <= 32 is read at run time and moves
// value by value (the encode dispatches the same way in launch_encode).
#define EXP_DELTA_DISPATCH(KERNEL, GRID, BLOCK, SMEM, ...)              \
  do {                                                                  \
    if (g == 16)                                                        \
      KERNEL<T, 16><<<GRID, BLOCK, SMEM, s>>>(__VA_ARGS__);             \
    else                                                                \
      KERNEL<T, 0><<<GRID, BLOCK, SMEM, s>>>(__VA_ARGS__);              \
  } while (0)

template <typename T, bool kDirect>
void launch_encode(const T* u, T* enc, uint8_t* base, const Geometry& q, int g,
                   int man_bits, uint32_t exp_mask, cudaStream_t s) {
  const unsigned tiles = (q.pages + q.tile_pages - 1) / q.tile_pages * q.chunks;
  const int threads = (q.tile_pages * q.chunk + 31) / 32 * 32;
  const int smem = kDirect ? 0 : q.tile_pages * g * q.row_bytes;
  if (g == 16)
    exp_delta_encode_kernel<T, 16, kDirect><<<tiles, threads, smem, s>>>(
        u, enc, base, q, g, man_bits, exp_mask);
  else
    exp_delta_encode_kernel<T, 0, kDirect><<<tiles, threads, smem, s>>>(
        u, enc, base, q, g, man_bits, exp_mask);
}

template <typename T>
int encode(const void* u, void* enc, void* base, const Geometry& q, int g, int man_bits,
           uint32_t exp_mask, cudaStream_t s) {
  const T* ut = static_cast<const T*>(u);
  T* et = static_cast<T*>(enc);
  uint8_t* bt = static_cast<uint8_t*>(base);
  if (q.path == kPathDirect)
    launch_encode<T, true>(ut, et, bt, q, g, man_bits, exp_mask, s);
  else
    launch_encode<T, false>(ut, et, bt, q, g, man_bits, exp_mask, s);
  return (int)cudaGetLastError();
}

template <typename T>
int decode(const void* enc, const void* base, void* u, int64_t rows, int g,
           int man_bits, uint32_t exp_mask, cudaStream_t s) {
  const T* et = static_cast<const T*>(enc);
  const uint8_t* bt = static_cast<const uint8_t*>(base);
  T* ut = static_cast<T*>(u);
  EXP_DELTA_DISPATCH(exp_delta_decode_kernel, blocks_for(rows), kThreads, 0, et, bt, ut,
                     rows, g, man_bits, exp_mask);
  return (int)cudaGetLastError();
}

// Whether a stride (values) keeps 16-byte vectors aligned.
bool vec_stride(long long n, long long stride, int width) {
  return n <= 1 || (stride * width) % 16 == 0;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width other than 1, 2 or 4 bytes, a group
// length outside [1, 32] or inputs the kernel does not take (below).
// Nothing to do launches nothing and returns 0.

// u (n0, n1, n2, t, c) raw bits, strides s0, s1, s2, st and 1 (values) ->
// enc (n0, n1, n2, ceil(t / g), c, g) contiguous and base (..., c) uint8.
// The tile plan (tile_pages, chunk, row_bytes) and the path come from the
// binding (kernels/exp_delta/kernel.py: plan); a path is refused where a
// pointer or stride would misalign a 16-byte vector it loads, and the
// direct path where a unit's values are not whole contiguous groups of one
// channel.  Pages and units must stay below 2^31.
int exp_delta_encode_launch(const void* u, void* enc, void* base, long long n0,
                            long long n1, long long n2, long long s0, long long s1,
                            long long s2, long long t, long long st, int c, int g,
                            int tile_pages, int chunk, int row_bytes, int path, int width,
                            int man_bits, int exp_mask, void* stream) {
  if (g < 1 || g > kMaxG || c < 1 || n0 < 0 || n1 < 1 || n2 < 1 || t < 0 ||
      (width != 1 && width != 2 && width != 4) || (g == 16 && misaligned(enc, enc)) ||
      path < kPathBytes || path > kPathDirect)
    return (int)cudaErrorInvalidValue;
  const long long n_pages = (t + g - 1) / g;
  const long long pages = n0 * n1 * n2 * n_pages;
  if (pages == 0) return 0;
  Geometry q{};
  q.chunks = (c + chunk - 1) / (chunk > 0 ? chunk : 1);
  if (pages * c >= (1LL << 31) || tile_pages < 1 || chunk < 1 || chunk > c ||
      tile_pages * chunk > kThreads || (q.chunks > 1 && tile_pages != 1) ||
      row_bytes < chunk * width || row_bytes % 16 != 0 ||
      (path != kPathDirect && tile_pages * g * row_bytes > kMaxTileBytes))
    return (int)cudaErrorInvalidValue;
  const bool leads_vec =
      vec_stride(n0, s0, width) && vec_stride(n1, s1, width) && vec_stride(n2, s2, width);
  if (path == kPathVec && (misaligned(u, u) || (c * width) % 16 != 0 ||
                           (chunk * width) % 16 != 0 || !vec_stride(t, st, width) ||
                           !leads_vec))
    return (int)cudaErrorInvalidValue;
  if (path == kPathDirect &&
      (c != 1 || st != 1 || t % g != 0 || (g == 16 && (misaligned(u, u) || !leads_vec))))
    return (int)cudaErrorInvalidValue;
  q.n1 = (unsigned)n1;
  q.n2 = (unsigned)n2;
  q.s0 = s0;
  q.s1 = s1;
  q.s2 = s2;
  q.t = t;
  q.st = st;
  q.n_pages = (unsigned)n_pages;
  q.pages = (unsigned)pages;
  q.c = c;
  q.tile_pages = tile_pages;
  q.chunk = chunk;
  q.row_bytes = row_bytes;
  q.path = path;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (uint32_t)exp_mask;
  switch (width) {
    case 1: return encode<uint8_t>(u, enc, base, q, g, man_bits, mask, s);
    case 2: return encode<uint16_t>(u, enc, base, q, g, man_bits, mask, s);
    default: return encode<uint32_t>(u, enc, base, q, g, man_bits, mask, s);
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
