// Flash-attention forward (online softmax over key tiles), for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention, _kernel), the
// TPU form of the forward every attention prefill of the reference runs
// (models/attention.py flash_attention).  It computes, for each batch row b,
// query i and query head h (kv head h / (Hp / Hkv), the grouped layout):
//   s_j  = (q_i . k_j) / sqrt(hd)                    float32
//   keep j < kv_valid[b]; if causal, j <= q_pos[b, i]; if window > 0,
//        j > q_pos[b, i] - window; other scores are the finite -1e30
//   out  = sum_j bf16(exp(s_j - m)) v_j / sum_j exp(s_j - m)
// with the running max m, the running sum and the accumulator in float32 and
// p rounded to bf16 before p . v, as the reference does.
//
// Layouts (the reference's, unchanged), contiguous:
//   q (B, Sq, Hp, hd) bf16   k, v (B, Skv, Hkv, hd) bf16   out like q
//   q_pos (B, Sq) int32      kv_valid (B,) int32
// hd is a multiple of 16 up to 128; Sq and Skv are any length (ragged edges
// are masked here, nothing is padded in device memory).
//
// What bounds it on this card: bf16 tensor-core operations.  At Zamba2-7B's
// prefill shape (B 2, L 4096, 32 heads of 112, causal) the causal half of
// the two products is 2 L^2 hd B H = 240.5 GFLOP, 0.243 ms at 989 TFLOP/s,
// against 235 MB of q, k, v and out, 0.070 ms at 3.35 TB/s.
//
// What the design does about it:
// - The products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   float32 accumulate); the softmax state and the output accumulator stay
//   in registers, so the scores never reach device memory.
// - One block of 4 warps per (query tile of 64 rows, q head, batch row);
//   each warp owns 16 query rows.  The q tile is read once into registers;
//   64-row key and value tiles pass through shared memory (v stored
//   transposed, so both products read 32-bit fragments).
// - Key tiles that the masks empty for every row of the query tile (past
//   kv_valid, above the causal diagonal, before the window) are skipped, so
//   a causal launch does the causal half of the work; the Pallas kernel
//   walks them.  Tiles are issued heaviest first.
// - A row whose first visited tile holds no key it may see keeps m = -1e30;
//   the next visible key's correction exp(-1e30 - m) = 0 wipes what it
//   gathered.  A row that sees no key at all returns 0.
//
// Known limits of this first version, left for a later change: no wgmma or
// TMA, no cp.async double buffering of the key tiles, no split over the keys
// (at short Sq a launch has B * Hp blocks), one block per 64-row tile.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per block, 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tiles {
  static constexpr int kLd = HD + 8;    // row length of the q and k tiles
  static constexpr int kLdV = kBK + 8;  // row length of the transposed v tile
  static constexpr int kElems = kBQ * kLd + kBK * kLd + HD * kLdV;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// c += a . b for one 16 x 8 x 16 tile (a row-major, b column-major).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, 64) of a (rows, H, HD) tensor at head h into a [64][ld] tile, 16
// bytes a thread; rows at or past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t row0,
                                          int H, int h, int valid) {
  constexpr int kVecs = HD / 8;
  for (int e = threadIdx.x; e < 64 * kVecs; e += kThreads) {
    const int r = e / kVecs, c = e % kVecs;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + ((row0 + r) * H + h) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// The same for v, stored transposed ([HD][ldv]); neighbouring threads take
// neighbouring rows so that their 2-byte stores share banks' words.
template <int HD>
__device__ __forceinline__ void load_rows_t(bf16* dst, int ldv, const bf16* src, size_t row0,
                                            int H, int h, int valid) {
  constexpr int kVecs = HD / 8;
  for (int e = threadIdx.x; e < 64 * kVecs; e += kThreads) {
    const int r = e % 64, c = e / 64;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + ((row0 + r) * H + h) * HD + c * 8);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[(c * 8 + 2 * i) * ldv + r] = __ushort_as_bfloat16((unsigned short)(w[i] & 0xffffu));
      dst[(c * 8 + 2 * i + 1) * ldv + r] = __ushort_as_bfloat16((unsigned short)(w[i] >> 16));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ q_pos,
                           const int* __restrict__ kv_valid, bf16* __restrict__ out, int Sq,
                           int Skv, int Hp, int Hkv, int causal, int window, float scale) {
  using T = Tiles<HD>;
  constexpr int kK = HD / 16;  // k-steps of q . k
  constexpr int kN = HD / 8;   // n-tiles of p . v
  constexpr int kS = kBK / 8;  // n-tiles of q . k
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * T::kLd;
  bf16* vt = ks + kBK * T::kLd;
  __shared__ int s_qmin, s_qmax;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hp / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kv_end = max(0, min(kv_valid[b], Skv));

  if (threadIdx.x == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (threadIdx.x < kBQ && q0 + (int)threadIdx.x < Sq) {
    const int p = q_pos[(size_t)b * Sq + q0 + threadIdx.x];
    atomicMin(&s_qmin, p);
    atomicMax(&s_qmax, p);
  }
  load_rows<HD>(qs, T::kLd, q, (size_t)b * Sq + q0, Hp, h, Sq - q0);
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;

  // this thread's two rows of the warp's 16: r and r + 8
  const int r0 = warp * 16 + g;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    qp[i] = row < Sq ? q_pos[(size_t)b * Sq + row] : qmin;
  }
  uint32_t qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const bf16* p = qs + r0 * T::kLd + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * T::kLd);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * T::kLd + 8);
  }

  int hi = kv_end;
  if (causal) hi = min(hi, qmax + 1);
  const int lo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int j_begin = lo / kBK;
  const int j_end = hi > 0 ? (hi + kBK - 1) / kBK : 0;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // every warp is done with the previous k and v tiles
    load_rows<HD>(ks, T::kLd, k, (size_t)b * Skv + k0, Hkv, hk, kv_end - k0);
    load_rows_t<HD>(vt, T::kLdV, v, (size_t)b * Skv + k0, Hkv, hk, kv_end - k0);
    __syncthreads();

    float s[kS][4];
#pragma unroll
    for (int n = 0; n < kS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* p = ks + (n * 8 + g) * T::kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) mma16816(s[n], qa[kk], ld32(p + kk * 16), ld32(p + kk * 16 + 8));
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kpos < kv_end && (!causal || kpos <= qp[i]) &&
                        (window <= 0 || kpos > qp[i] - window);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const bf16* p = vt + (n * 8 + g) * T::kLdV + kk * 16 + 2 * t;
        mma16816(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* o = out + (((size_t)b * Sq + row) * Hp + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_valid, void* out, int B, int Sq, int Skv, int Hp, int Hkv,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = Tiles<HD>::kElems * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hp, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid),
      static_cast<bf16*>(out), Sq, Skv, Hp, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = launched); cudaErrorInvalidValue
// for a head_dim the kernel is not built for (a multiple of 16 up to 128).
int flash_attention_launch(const void* q, const void* k, const void* v, const void* q_pos,
                           const void* kv_valid, void* out, int B, int Sq, int Skv, int Hp,
                           int Hkv, int hd, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 32: return launch<32>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 48: return launch<48>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 64: return launch<64>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 80: return launch<80>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 96: return launch<96>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 112: return launch<112>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    case 128: return launch<128>(q, k, v, q_pos, kv_valid, out, B, Sq, Skv, Hp, Hkv, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
