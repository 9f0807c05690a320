// Hopper kernel 5 of the port: one decode step of paged GQA attention.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention :103, body _decode_kernel :37).  Plain version:
// repro_torch/kernels/ref.py paged_attention_ref.
//
//   out[b, h, :] = softmax_t( cap(q[b, h] . k[t] * scale) ) . v[t]
//
// over the positions t < seq_lens[b] of sequence b, whose K/V rows live in
// the pages page_table[b, 0..] of the head-major pool [KVH, P, page, D].
// An empty sequence (seq_len == 0) gives zeros.
//
// The TPU kernel walked a (batch, kv_head, page) grid in order, fetched one
// page per step through scalar prefetch in its BlockSpec index map, and
// carried the online-softmax state in VMEM scratch across steps.  Here:
//   * one CTA per (sequence, KV head): its G = H / KVH query rows sit in f32
//     shared memory, so each K/V row read from HBM serves all G heads (the
//     reuse the TPU kernel got from its [G, D] tile);
//   * the CTA walks only the pages p < ceil(seq_len / page), reading the
//     page id from the page table itself;
//   * scores: each warp takes tokens of the page, its lanes split D, and a
//     __shfl_xor_sync reduction finishes each dot product;
//   * online softmax across pages in f32 (m, l and acc[G, D] in shared
//     memory); positions past seq_len are never scored, so no exp(-inf -
//     -inf) arises; the output is acc / (l > 0 ? l : 1);
//   * IEEE math: expf, tanhf and correctly rounded division (the build
//     never passes --use_fast_math).
//
// Bound: bytes.  The function must read seq_len x D x 2 (K and V) elements
// per (sequence, KV head), plus q, and write out: at deepseek-7b's width
// (32 KV heads x 128 x bf16) that is 16 KiB per token per layer.  This
// first design is latency-bound instead (one page at a time, three barriers
// per page); split-K over pages, cp.async/TMA prefetch of the next page and
// tensor-core products are left for the redesign.
//
// The C entry returns cudaGetLastError() after its launch.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -3.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared memory (floats): q_s [G, D], acc [G, D], sc [G, page], m, l,
// alpha [G].  Grid (KVH, B), kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int32_t* __restrict__ page_table,
                           const int32_t* __restrict__ seq_lens,
                           T* __restrict__ out, int H, int P, int page,
                           int PPS, int G, float scale, float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc = q_s + G * D;
  float* sc = acc + G * D;
  float* m_s = sc + G * page;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq_len = seq_lens[b];
  const int64_t qoff = ((int64_t)b * H + (int64_t)kh * G) * D;

  if (seq_len <= 0) {
    for (int i = tid; i < G * D; i += kThreads)
      out[qoff + i] = from_f32<T>(0.f);
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  constexpr int kPer = (D + 31) / 32;  // elements of a row per lane
  // positions past the table's PPS pages are not attended (as the plain
  // version, which gathers exactly PPS pages)
  const int n_pages = min((seq_len + page - 1) / page, PPS);
  for (int p = 0; p < n_pages; ++p) {
    const int pid = page_table[(int64_t)b * PPS + p];
    const int64_t base = ((int64_t)kh * P + pid) * page * D;
    const T* kpage = kp + base;
    const T* vpage = vp + base;
    const int valid = min(page, seq_len - p * page);

    // scores of the valid tokens: one warp per token, lanes split D
    for (int t = warp; t < valid; t += kWarps) {
      float kr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < D ? to_f32(kpage[(int64_t)t * D + d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          if (d < D) s = fmaf(q_s[g * D + d], kr[i], s);
        }
        s = warp_sum(s);
        if (lane == 0) {
          s *= scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          sc[g * page + t] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row; sc becomes the weights
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sc[g * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float e = expf(sc[g * page + t] - m_new);
        sc[g * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + w . V: one thread per column d, all G rows
    for (int d = tid; d < D; d += kThreads) {
      for (int g = 0; g < G; ++g) acc[g * D + d] *= alpha_s[g];
      for (int t = 0; t < valid; ++t) {
        const float v = to_f32(vpage[(int64_t)t * D + d]);
        for (int g = 0; g < G; ++g)
          acc[g * D + d] = fmaf(sc[g * page + t], v, acc[g * D + d]);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    out[qoff + i] = from_f32<T>(acc[i] / (l > 0.f ? l : 1.f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* sl, void* out, int B, int H, int KVH, int P, int page,
           int PPS, float scale, float softcap, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * (2 * (size_t)G * D + (size_t)G * page +
                                       3 * (size_t)G);
  auto kernel = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(KVH, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,
      (const int32_t*)sl, (T*)out, H, P, page, PPS, G, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kp, const void* vp,
               const void* pt, const void* sl, void* out, int B, int H,
               int KVH, int P, int page, int PPS, float scale, float softcap,
               cudaStream_t stream) {
#define RK_PA_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<T, DD>(q, kp, vp, pt, sl, out, B, H, KVH, P, page, PPS,  \
                         scale, softcap, stream);
  switch (D) {
    RK_PA_CASE(16)
    RK_PA_CASE(64)
    RK_PA_CASE(80)
    RK_PA_CASE(128)
    RK_PA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RK_PA_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q/out [B, H, D]; pools [KVH, P, page, D];
// page_table int32 [B, PPS]; seq_lens int32 [B]; all contiguous.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out, int B,
                                      int H, int KVH, int P, int page,
                                      int PPS, int D, int dtype, float scale,
                                      float softcap, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || PPS <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_pages, v_pages, page_table, seq_lens,
                             out, B, H, KVH, P, page, PPS, scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, page_table,
                                     seq_lens, out, B, H, KVH, P, page, PPS,
                                     scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
