// Hopper kernel 5 of the port: one decode step of paged GQA attention,
// as a split-K flash decode.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention :103, body _decode_kernel :37).  Plain version:
// repro_torch/kernels/ref.py paged_attention_ref.
//
//   out[b, h, :] = softmax_t( cap(q[b, h] . k[t] * scale) ) . v[t]
//
// over the positions t < seq_lens[b] of sequence b (at most the table's
// PPS pages), whose K/V rows live in the pages page_table[b, 0..] of the
// head-major pool [KVH, P, page, D].  An empty sequence gives zeros.
//
// Bound: bytes.  The function reads each valid K and V row once (at
// deepseek-7b's width, 32 KV heads x 128 x bf16, 16 KiB per token per
// layer) and does 4 x H x D operations per token, far below the card's
// rate.  The TPU kernel walked a (batch, kv_head, page) grid in order and
// carried the online softmax in VMEM scratch; on 132 SMs that order would
// leave the card idle, so here:
//   * split-K: the grid is (KVH, B, S); CTA s takes the pages
//     [s*ppc, (s+1)*ppc) of its sequence.  S and ppc are chosen on the host
//     from the table width PPS and the SM count, never from seq_lens (no
//     device sync in a decode step).  A CTA past ceil(seq_len / page)
//     writes an empty partial (m = -inf, l = 0, acc = 0);
//   * each of the CTA's W warps owns every W-th page of the range and
//     keeps its own online softmax (m, l, acc[G, D]) in registers; the
//     warps merge once, at the end of the CTA;
//   * a warp streams its pages through a 2-stage shared-memory ring with
//     16-byte cp.async (8 bf16 or 4 f32 per lane; a row of D = 128 bf16 is
//     16 lanes x 16 B): page k+1's K and V are in flight while page k is
//     scored.  The warp reads its pages' ids from the table up front.
//     Only the valid rows of a page are fetched; a row is D x 2 or 4 bytes,
//     a multiple of 16 for every supported D;
//   * scores: lane c owns columns c, c+32, ..; a warp sum per token and
//     query head; lane t keeps token t's score (page <= 32);
//   * combine: the CTA's partial (m, l, acc) goes to an f32 workspace; the
//     last CTA of each (b, kv head), found by an atomic ticket that it
//     resets to 0 itself, merges the S partials in f32:
//       out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
//     where an empty partial (m_s = -inf) weighs 0 and an all-empty
//     sequence gives 0, never NaN.  No memset launch is needed.
//   * f32 FMAs, no tensor cores: the serving model is MHA (G = 1), so no
//     K/V row is shared by query heads, and the f32 path needs IEEE
//     products to hold 2e-5.  IEEE expf, tanhf and division (the build
//     never passes --use_fast_math).
//
// The C entry returns cudaGetLastError() after its launch.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;
constexpr int kStages = 2;
constexpr int kMaxG = 8;

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
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// e^(m - M), 0 for an empty partial (m = -inf)
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

// Dynamic shared memory: ring [W][kStages][K, V][page * D] of T, then f32
// q_s [G * D], wacc [W][G * D], wm [W][G], wl [W][G].
// Workspace part [B * KVH][S][G * D + 2G]: acc, then m, then l.
template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(32 * kMaxWarps)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int32_t* __restrict__ page_table,
                           const int32_t* __restrict__ seq_lens,
                           T* __restrict__ out, float* __restrict__ part,
                           int32_t* __restrict__ tickets, int H, int P,
                           int page, int PPS, int G, int ppc, float scale,
                           float softcap) {
  constexpr int kPer = (D + 31) / 32;       // columns per lane
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr bool kQReg = MAXG * kPer <= 16;  // q in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;

  const int W = blockDim.x >> 5;
  const int KVH = gridDim.x, S = gridDim.z;
  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const int stage = page * D;
  const int64_t bk = (int64_t)b * KVH + kh;
  const int64_t pstride = GD + 2 * G;
  float* mypart = part + (bk * S + s) * pstride;

  T* ring = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + (size_t)W * kStages * 2 * stage);
  float* wacc = q_s + GD;
  float* wm = wacc + (size_t)W * GD;
  float* wl = wm + W * G;

  const int seq_len = seq_lens[b];
  // positions past the table's PPS pages are not attended (as the plain
  // version, which gathers exactly PPS pages)
  const int n_pages =
      seq_len <= 0 ? 0 : min((seq_len + page - 1) / page, PPS);
  const int p0 = s * ppc;
  const int p1 = min(p0 + ppc, n_pages);

  if (p0 < p1) {
    const int64_t qoff = ((int64_t)b * H + (int64_t)kh * G) * D;
    for (int i = tid; i < GD; i += blockDim.x) q_s[i] = to_f32(q[qoff + i]);
    __syncthreads();

    float qr[kQReg ? MAXG : 1][kPer];
    if constexpr (kQReg) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          qr[g][i] = (g < G && d < D) ? q_s[g * D + d] : 0.f;
        }
    }
    float acc[MAXG][kPer], m[MAXG], l[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[g][i] = 0.f;
    }

    // this warp's pages: p0 + warp + k * W for k < cnt (cnt <= 32)
    const int cnt = p1 - p0 > warp ? (p1 - p0 - warp + W - 1) / W : 0;
    const int my_pid =
        lane < cnt ? page_table[(int64_t)b * PPS + p0 + warp + lane * W] : 0;
    T* wring = ring + (size_t)warp * kStages * 2 * stage;

    auto issue = [&](int k) {
      if (k < cnt) {
        const int pid = __shfl_sync(kFull, my_pid, k);
        const int p = p0 + warp + k * W;
        const int nvec = min(page, seq_len - p * page) * (D / kVec);
        const int64_t base = ((int64_t)kh * P + pid) * stage;
        T* sk = wring + (k % kStages) * 2 * stage;
        for (int v = lane; v < nvec; v += 32) {
          cp_async16(sk + v * kVec, kp + base + v * kVec);
          cp_async16(sk + stage + v * kVec, vp + base + v * kVec);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };

    issue(0);
    for (int k = 0; k < cnt; ++k) {
      issue(k + 1);
      cp_async_wait_one();
      __syncwarp();
      const T* sk = wring + (k % kStages) * 2 * stage;
      const T* sv = sk + stage;
      const int valid = min(page, seq_len - (p0 + warp + k * W) * page);

      float sc[MAXG];  // lane t: token t's score, then its weight
#pragma unroll
      for (int g = 0; g < MAXG; ++g) sc[g] = -INFINITY;
      for (int t = 0; t < valid; ++t) {
        float kr[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          kr[i] = d < D ? to_f32(sk[t * D + d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            float x = 0.f;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int d = lane + 32 * i;
              float qv;
              if constexpr (kQReg) {
                qv = qr[g][i];
              } else {
                qv = d < D ? q_s[g * D + d] : 0.f;
              }
              x = fmaf(qv, kr[i], x);
            }
            x = warp_sum(x) * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            if (lane == t) sc[g] = x;
          }
        }
      }

      // online softmax of this page (valid >= 1, so m_new is finite)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float m_new = fmaxf(m[g], warp_max(sc[g]));
          const float alpha = expf(m[g] - m_new);
          const float p = lane < valid ? expf(sc[g] - m_new) : 0.f;
          l[g] = l[g] * alpha + warp_sum(p);
          m[g] = m_new;
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[g][i] *= alpha;
          sc[g] = p;
        }
      }

      for (int t = 0; t < valid; ++t) {
        float vr[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          vr[i] = d < D ? to_f32(sv[t * D + d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float pt = __shfl_sync(kFull, sc[g], t);
#pragma unroll
            for (int i = 0; i < kPer; ++i) acc[g][i] = fmaf(pt, vr[i], acc[g][i]);
          }
        }
      }
      __syncwarp();  // the stage is refilled by the next issue
    }

    // the warps merge once
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        if (lane == 0) {
          wm[warp * G + g] = m[g];
          wl[warp * G + g] = l[g];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          if (d < D) wacc[(size_t)warp * GD + g * D + d] = acc[g][i];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < GD; i += blockDim.x) {
      const int g = i / D;
      float M = -INFINITY;
      for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * G + g]);
      float a = 0.f;
      for (int w = 0; w < W; ++w)
        a = fmaf(weight(wm[w * G + g], M), wacc[(size_t)w * GD + i], a);
      mypart[i] = a;
    }
    for (int g = tid; g < G; g += blockDim.x) {
      float M = -INFINITY;
      for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * G + g]);
      float sum = 0.f;
      for (int w = 0; w < W; ++w)
        sum = fmaf(weight(wm[w * G + g], M), wl[w * G + g], sum);
      mypart[GD + g] = M;
      mypart[GD + G + g] = sum;
    }
  } else {
    for (int i = tid; i < GD; i += blockDim.x) mypart[i] = 0.f;
    for (int g = tid; g < G; g += blockDim.x) {
      mypart[GD + g] = -INFINITY;
      mypart[GD + G + g] = 0.f;
    }
  }

  // the last CTA of (b, kh) merges the S partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[bk], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pb = part + bk * S * pstride;
  const int64_t ooff = ((int64_t)b * H + (int64_t)kh * G) * D;
  for (int i = tid; i < GD; i += blockDim.x) {
    const int g = i / D;
    float M = -INFINITY;
    for (int j = 0; j < S; ++j) M = fmaxf(M, __ldcg(pb + j * pstride + GD + g));
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int j = 0; j < S; ++j) {
        const float* pj = pb + j * pstride;
        const float w = weight(__ldcg(pj + GD + g), M);
        if (w > 0.f) {
          num = fmaf(w, __ldcg(pj + i), num);
          den = fmaf(w, __ldcg(pj + GD + G + g), den);
        }
      }
    }
    out[ooff + i] = from_f32<T>(den > 0.f ? num / den : 0.f);
  }
  if (tid == 0) tickets[bk] = 0;
}

size_t smem_bytes(int W, int G, int D, int page, size_t elem) {
  return (size_t)W * kStages * 2 * page * D * elem +
         sizeof(float) * ((size_t)(W + 1) * G * D + 2 * (size_t)W * G);
}

template <typename T, int D, int MAXG>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* sl, void* out, void* part, void* tickets, int B, int H,
           int KVH, int P, int page, int PPS, int S, int ppc, int W,
           float scale, float softcap, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = smem_bytes(W, G, D, page, sizeof(T));
  auto kernel = paged_attention_kernel<T, D, MAXG>;
  // The opt-in is per device, so it is set on every launch that needs it.
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(KVH, B, S), 32 * W, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,
      (const int32_t*)sl, (T*)out, (float*)part, (int32_t*)tickets, H, P,
      page, PPS, G, ppc, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, int G, const void* q, const void* kp, const void* vp,
             const void* pt, const void* sl, void* out, void* part,
             void* tickets, int B, int H, int KVH, int P, int page, int PPS,
             int S, int ppc, int W, float scale, float softcap,
             cudaStream_t stream) {
#define RK_PA_CASE(DD)                                                      \
  case DD:                                                                  \
    return G == 1 ? launch<T, DD, 1>(q, kp, vp, pt, sl, out, part, tickets, \
                                     B, H, KVH, P, page, PPS, S, ppc, W,    \
                                     scale, softcap, stream)                \
                  : launch<T, DD, kMaxG>(q, kp, vp, pt, sl, out, part,      \
                                         tickets, B, H, KVH, P, page, PPS,  \
                                         S, ppc, W, scale, softcap, stream);
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

// dtype: 0 float32, 1 bfloat16.  q/out [B, H, D]; pools [KVH, P, page, D]
// (16-byte aligned); page_table int32 [B, PPS]; seq_lens int32 [B]; all
// contiguous.  part: f32 workspace [B * KVH * S * (G * D + 2G)]; tickets:
// int32 [B * KVH], zero before the launch and zero after it.  W warps per
// CTA, ppc pages per CTA, S = ceil(PPS / ppc) splits.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, void* part,
    void* tickets, int B, int H, int KVH, int P, int page, int PPS, int D,
    int dtype, int S, int ppc, int W, float scale, float softcap,
    void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || page <= 0 || page > 32 ||
      PPS <= 0 || P <= 0 || W < 1 || W > kMaxWarps || ppc < 1 ||
      ppc > 32 * W || S != (PPS + ppc - 1) / ppc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = H / KVH;
  if (dtype == 0)
    return dispatch<float>(D, G, q, k_pages, v_pages, page_table, seq_lens,
                           out, part, tickets, B, H, KVH, P, page, PPS, S,
                           ppc, W, scale, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, G, q, k_pages, v_pages, page_table,
                                   seq_lens, out, part, tickets, B, H, KVH, P,
                                   page, PPS, S, ppc, W, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
