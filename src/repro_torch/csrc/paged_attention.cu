// Paged decode attention over a bit-plane KV cache, for Hopper (sm_90a).
//
// Replaces the reference's two Pallas TPU kernels in
// src/repro/kernels/paged_attention/kernel.py:
//   * paged_attention_fused (_fused_kernel): one launch over the
//     mixed-precision cache, each page read at its own plane count, output
//     normalised, rows with nothing valid written as 0;
//   * paged_attention_rung (_kernel): the same attention at one plane count
//     for every masked-in token, output as unnormalised partials
//     (acc, m, l) that the caller merges across rungs.
//
// Layouts (the reference's, unchanged):
//   q        (B, Hkv, rep, hd)          bf16
//   k/v      (bits, B, S, Hkv, hd/8)    uint8; bit i (0 = MSB) of value d of
//                                       token s sits in planes[i][b][s][h]
//                                       [d/8] at bit 7 - d%8
//   keeps    (B, S/16)                  int32 (fused only)
//   mask     (B, S)                     int8, > 0 = valid
//   out      (B, Hkv, rep, hd)          float32
//   m, l     (B, Hkv, rep)              float32 (rung only)
//
// What bounds it on this card: bytes.  Per layer the kernel must move
// sum over read pages of keep * 16 * Hkv * (hd/8) bytes for each of K and V,
// plus q, the mask and the output; it does about 4 flops per value it
// rebuilds, far below the H100's ~300 operations per byte.
//
// What the design does about it: a page whose 16 mask bytes are all zero,
// or whose keep is 0, is skipped and none of its planes is read, so the
// planes below keep and the pages past a slot's valid length never leave
// device memory.  Planes [0, keep) of a page are gathered once into shared
// memory, rebuilt into float32 there, and used by every query row of the
// kv head (the GQA group) before the next page is loaded.
//
// Known limits of this first version, left for a later change:
//   * one block per (kv head, batch row) with a loop over pages: at B = 8
//     and Hkv = 3 that is 24 blocks on 132 SMs (no split over S);
//   * the plane layout keeps each token's 8-byte plane row at a stride of
//     Hkv * hd/8 bytes, so the gather is poorly coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPage = 16;
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float bits_to_float(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ kp,
                       const uint8_t* __restrict__ vp,
                       const int32_t* __restrict__ page_keeps,
                       const int8_t* __restrict__ mask,
                       float* __restrict__ out,
                       float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       int B, int S, int Hkv, int rep, int hd, int bits,
                       int rung_keep, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int hd8 = hd >> 3;
  const int n_pages = S / kPage;

  extern __shared__ float smem[];
  float* qf = smem;                    // rep * hd
  float* acc = qf + rep * hd;          // rep * hd
  float* kf = acc + rep * hd;          // kPage * hd
  float* vf = kf + kPage * hd;         // kPage * hd
  float* pr = vf + kPage * hd;         // rep * kPage: scores, then bf16(p)
  float* m_s = pr + rep * kPage;       // rep
  float* l_s = m_s + rep;              // rep
  float* corr = l_s + rep;             // rep
  uint8_t* kb = reinterpret_cast<uint8_t*>(corr + rep);  // bits*kPage*hd8
  uint8_t* vb = kb + bits * kPage * hd8;

  const size_t row = (size_t)b * Hkv + h;
  const __nv_bfloat16* qrow = q + row * rep * hd;
  for (int x = tid; x < rep * hd; x += nt) {
    qf[x] = __bfloat162float(qrow[x]);
    acc[x] = 0.f;
  }
  for (int r = tid; r < rep; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const size_t plane_stride = (size_t)B * S * Hkv * hd8;
  const int8_t* mrow = mask + (size_t)b * S;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    int keep = kFused ? page_keeps[(size_t)b * n_pages + p] : rung_keep;
    keep = keep < bits ? keep : bits;
    const int tok0 = p * kPage;
    const int valid = tid < kPage ? (mrow[tok0 + tid] > 0) : 0;
    // block-uniform: every thread takes the same branch
    if (!__syncthreads_or(valid) || keep <= 0) continue;

    // gather planes [0, keep) of this page's 16 rows (planes >= keep are
    // never touched)
    const int nbytes = keep * kPage * hd8;
    for (int x = tid; x < nbytes; x += nt) {
      const int j = x % hd8;
      const int t = (x / hd8) % kPage;
      const int i = x / (hd8 * kPage);
      const size_t g = i * plane_stride +
                       (((size_t)b * S + tok0 + t) * Hkv + h) * hd8 + j;
      kb[x] = kp[g];
      vb[x] = vp[g];
    }
    __syncthreads();

    // rebuild each bf16 value from its planes: sum of bit << (15 - i)
    for (int x = tid; x < kPage * hd; x += nt) {
      const int t = x / hd;
      const int d = x % hd;
      const int byte = d >> 3;
      const int sh = 7 - (d & 7);
      uint32_t uk = 0, uv = 0;
      for (int i = 0; i < keep; ++i) {
        const int idx = (i * kPage + t) * hd8 + byte;
        uk |= ((uint32_t)(kb[idx] >> sh) & 1u) << (15 - i);
        uv |= ((uint32_t)(vb[idx] >> sh) & 1u) << (15 - i);
      }
      kf[x] = bits_to_float(uk);
      vf[x] = bits_to_float(uv);
    }
    __syncthreads();

    // scores q.k in float32 from bf16 inputs
    for (int x = tid; x < rep * kPage; x += nt) {
      const int r = x / kPage;
      const int t = x % kPage;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qf[r * hd + d], kf[t * hd + d], s);
      pr[x] = mrow[tok0 + t] > 0 ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax state, one thread per query row
    for (int r = tid; r < rep; r += nt) {
      float mx = m_s[r];
      for (int t = 0; t < kPage; ++t) mx = fmaxf(mx, pr[r * kPage + t]);
      const float c = expf(m_s[r] - mx);
      float sum = 0.f;
      for (int t = 0; t < kPage; ++t) {
        const float pv = expf(pr[r * kPage + t] - mx);
        sum += pv;
        pr[r * kPage + t] = round_to_bf16(pv);  // p.astype(bf16) before p.v
      }
      l_s[r] = l_s[r] * c + sum;
      m_s[r] = mx;
      corr[r] = c;
    }
    __syncthreads();

    for (int x = tid; x < rep * hd; x += nt) {
      const int r = x / hd;
      const int d = x % hd;
      float a = acc[x] * corr[r];
      for (int t = 0; t < kPage; ++t) a = fmaf(pr[r * kPage + t], vf[t * hd + d], a);
      acc[x] = a;
    }
    __syncthreads();
  }

  float* orow = out + row * rep * hd;
  for (int x = tid; x < rep * hd; x += nt) {
    const int r = x / hd;
    if (kFused) {
      const float o = acc[x] / fmaxf(l_s[r], 1e-30f);
      orow[x] = m_s[r] > kNegInf * 0.5f ? o : 0.f;
    } else {
      orow[x] = acc[x];
    }
  }
  if (!kFused) {
    for (int r = tid; r < rep; r += nt) {
      m_out[row * rep + r] = m_s[r];
      l_out[row * rep + r] = l_s[r];
    }
  }
}

size_t smem_bytes(int rep, int hd, int bits) {
  const size_t floats = 2 * (size_t)rep * hd + 2 * (size_t)kPage * hd +
                        (size_t)rep * kPage + 3 * (size_t)rep;
  return floats * sizeof(float) + 2 * (size_t)bits * kPage * (hd / 8);
}

template <bool kFused>
int launch(const void* q, const void* kp, const void* vp, const void* keeps,
           const void* mask, void* out, void* m_out, void* l_out, int B,
           int S, int Hkv, int rep, int hd, int bits, int rung_keep,
           float scale, void* stream) {
  const size_t smem = smem_bytes(rep, hd, bits);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<kFused>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Hkv, B);
  paged_attention_kernel<kFused><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kp),
      static_cast<const uint8_t*>(vp), static_cast<const int32_t*>(keeps),
      static_cast<const int8_t*>(mask), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, S, Hkv, rep,
      hd, bits, rung_keep, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int paged_attention_fused_launch(const void* q, const void* kp,
                                 const void* vp, const void* page_keeps,
                                 const void* mask, void* out, int B, int S,
                                 int Hkv, int rep, int hd, int bits,
                                 float scale, void* stream) {
  return launch<true>(q, kp, vp, page_keeps, mask, out, nullptr, nullptr, B,
                      S, Hkv, rep, hd, bits, 0, scale, stream);
}

int paged_attention_rung_launch(const void* q, const void* kp, const void* vp,
                                const void* mask, void* out, void* m_out,
                                void* l_out, int B, int S, int Hkv, int rep,
                                int hd, int bits, int keep, float scale,
                                void* stream) {
  return launch<false>(q, kp, vp, nullptr, mask, out, m_out, l_out, B, S, Hkv,
                       rep, hd, bits, keep, scale, stream);
}

}  // extern "C"
