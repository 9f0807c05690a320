// The port's AdamW update of every leaf: three launches a step, whatever
// the leaf count.
//
// Replaces no Pallas kernel.  The reference's update
// (repro/optim/adamw.py update :80) is traced under jit, where XLA fuses
// each leaf's chain into one loop; eager torch ran about a dozen kernels a
// leaf and held up to four float32 temporaries of the largest leaf.  Plain
// version: repro_torch/kernels/adamw.py adamw_step_plain / sumsq_plain.
//
//   sumsq:   sum over every leaf and element of float32(g)^2
//   update:  g = g * scale
//            m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
//            w = w - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd w)
//            p = w, rounded to p's dtype (nearest even)
//
// Leaves: one int64 row each of a device table (struct Leaf): the
// addresses of g (bf16 or float32; 0 for a leaf without gradient, read as
// zeros), m, v, w (float32) and p (bf16 or float32; 0: not written), its
// element count and its first chunk.  A leaf is cut into chunks of `chunk`
// elements (the wrapper's CHUNK, a multiple of kThreads * kVec), numbered
// across leaves; a fixed grid walks the chunks grid-stride and finds each
// chunk's leaf by binary search of the table.
// Zero-size leaves have no row.
//
// Bound: bytes.  The update reads g, m, v, w and writes m, v, w, p: 28 B an
// element with bf16 g and p; the norm reads g once more (30 B in all).
// About 15 float operations an element is far below the card's rate.  So:
//   * one pass over everything the update touches, no temporaries: each
//     thread takes 4 consecutive elements, as 16-byte float32 loads and
//     8-byte bf16 loads where the leaf's addresses are 16-byte aligned
//     (else element by element), and a chunk's ragged end element by
//     element;
//   * the norm is a separate pass, since the clip scale needs all of it
//     first.  Each block sums its chunks' squares in double and writes one
//     partial; a one-block launch adds the partials in a fixed order and
//     writes float32.  The grid depends only on the SM count, so the same
//     inputs give the same bits (no float atomics).
//
// Rounding: every operation is an explicit _rn intrinsic, in the plain
// version's order, so nvcc contracts nothing into an FMA (the plain
// version's separate torch ops never fuse); b1, 1 - b1, b2, 1 - b2, eps and
// wd come as the float32 values torch rounds those Python scalars to;
// scale, lr, bc1 and bc2 are read from the 0-d float32 device tensors the
// optimizer computes (no host sync).  With equal scale the update is bit
// for bit the plain version's.
//
// The C entries return cudaGetLastError() after their launches.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Dtype { kNone = 0, kF32 = 1, kBF16 = 2 };

struct Leaf {
  int64_t g, m, v, w, p;  // addresses; g or p 0 when absent
  int64_t n;              // elements (> 0)
  int64_t chunk0;         // the leaf's first chunk
  int64_t flags;          // g dtype | p dtype << 8 | 16-byte aligned << 16
};
static_assert(sizeof(Leaf) == 64, "the wrapper's table rows are 8 int64");

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // float32 of the Python scalars
  float scale, lr, bc1, bc2;          // read from the device
};

// The leaf holding chunk c: the last row whose chunk0 <= c.
__device__ __forceinline__ int find_leaf(const Leaf* t, int L, int64_t c) {
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float bf16_bits(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Four consecutive elements of a float32 or bf16 array as float32.
template <int DT>
__device__ __forceinline__ void load4(int64_t base, int64_t i, float (&x)[4]) {
  if (DT == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + i);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if (DT == kBF16) {
    const uint2 a = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const uint16_t*>(base) + i);
    x[0] = bf16_bits(a.x & 0xFFFFu); x[1] = bf16_bits(a.x >> 16);
    x[2] = bf16_bits(a.y & 0xFFFFu); x[3] = bf16_bits(a.y >> 16);
  } else {
    x[0] = x[1] = x[2] = x[3] = 0.0f;
  }
}

template <int DT>
__device__ __forceinline__ float load1(int64_t base, int64_t i) {
  if (DT == kF32) return reinterpret_cast<const float*>(base)[i];
  if (DT == kBF16) return bf16_bits(reinterpret_cast<const uint16_t*>(base)[i]);
  return 0.0f;
}

__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int DT>
__device__ __forceinline__ void store4(int64_t base, int64_t i,
                                       const float (&x)[4]) {
  if (DT == kF32) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(base) + i) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else if (DT == kBF16) {
    uint2 a;
    a.x = to_bf16(x[0]) | (static_cast<uint32_t>(to_bf16(x[1])) << 16);
    a.y = to_bf16(x[2]) | (static_cast<uint32_t>(to_bf16(x[3])) << 16);
    *reinterpret_cast<uint2*>(reinterpret_cast<uint16_t*>(base) + i) = a;
  }
}

template <int DT>
__device__ __forceinline__ void store1(int64_t base, int64_t i, float x) {
  if (DT == kF32) reinterpret_cast<float*>(base)[i] = x;
  else if (DT == kBF16) reinterpret_cast<uint16_t*>(base)[i] = to_bf16(x);
}

// One element, in the plain version's order of operations.
__device__ __forceinline__ void adam(float g, float& m, float& v, float& w,
                                     const Hyper& h) {
  g = __fmul_rn(g, h.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, h.omb2), g));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  u = __fadd_rn(u, __fmul_rn(w, h.wd));
  w = __fsub_rn(w, __fmul_rn(u, h.lr));
}

// Elements [off, off + len) of one leaf.
template <int GT, int PT>
__device__ void update_span(const Leaf& L, int64_t off, int64_t len,
                            bool vec, const Hyper& h) {
  float* m = reinterpret_cast<float*>(L.m);
  float* v = reinterpret_cast<float*>(L.v);
  float* w = reinterpret_cast<float*>(L.w);
  int64_t done = 0;
  if (vec) {
    const int64_t nv = len / kVec * kVec;
    for (int64_t j = threadIdx.x * kVec; j < nv; j += kThreads * kVec) {
      const int64_t i = off + j;
      float g[4], mm[4], vv[4], ww[4];
      load4<GT>(L.g, i, g);
      load4<kF32>(L.m, i, mm);
      load4<kF32>(L.v, i, vv);
      load4<kF32>(L.w, i, ww);
#pragma unroll
      for (int k = 0; k < 4; ++k) adam(g[k], mm[k], vv[k], ww[k], h);
      store4<kF32>(L.m, i, mm);
      store4<kF32>(L.v, i, vv);
      store4<kF32>(L.w, i, ww);
      store4<PT>(L.p, i, ww);
    }
    done = nv;
  }
  for (int64_t j = done + threadIdx.x; j < len; j += kThreads) {
    const int64_t i = off + j;
    float mm = m[i], vv = v[i], ww = w[i];
    adam(load1<GT>(L.g, i), mm, vv, ww, h);
    m[i] = mm;
    v[i] = vv;
    w[i] = ww;
    store1<PT>(L.p, i, ww);
  }
}

template <int GT>
__device__ __forceinline__ void update_g(const Leaf& L, int pt, int64_t off,
                                         int64_t len, bool vec,
                                         const Hyper& h) {
  if (pt == kBF16) update_span<GT, kBF16>(L, off, len, vec, h);
  else if (pt == kF32) update_span<GT, kF32>(L, off, len, vec, h);
  else update_span<GT, kNone>(L, off, len, vec, h);
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const Leaf* __restrict__ table, int leaves, int64_t chunks,
              int64_t chunk, const float* __restrict__ scale,
              const float* __restrict__ lr, const float* __restrict__ bc1,
              const float* __restrict__ bc2, float b1, float omb1, float b2,
              float omb2, float eps, float wd) {
  const Hyper h{b1, omb1, b2, omb2, eps, wd, *scale, *lr, *bc1, *bc2};
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Leaf L = table[find_leaf(table, leaves, c)];
    const int64_t off = (c - L.chunk0) * chunk;
    const int64_t len = L.n - off < chunk ? L.n - off : chunk;
    const int gt = static_cast<int>(L.flags & 0xFF);
    const int pt = static_cast<int>((L.flags >> 8) & 0xFF);
    const bool vec = (L.flags >> 16) & 1;
    if (gt == kBF16) update_g<kBF16>(L, pt, off, len, vec, h);
    else if (gt == kF32) update_g<kF32>(L, pt, off, len, vec, h);
    else update_g<kNone>(L, pt, off, len, vec, h);
  }
}

// The block's sum of its threads' doubles, in a fixed order; valid in
// thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  x = threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  }
  return x;
}

template <int GT>
__device__ __forceinline__ double sumsq_span(const Leaf& L, int64_t off,
                                             int64_t len, bool vec) {
  double acc = 0.0;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = len / kVec * kVec;
    for (int64_t j = threadIdx.x * kVec; j < nv; j += kThreads * kVec) {
      float g[4];
      load4<GT>(L.g, off + j, g);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc += static_cast<double>(__fmul_rn(g[k], g[k]));
    }
    done = nv;
  }
  for (int64_t j = done + threadIdx.x; j < len; j += kThreads) {
    const float g = load1<GT>(L.g, off + j);
    acc += static_cast<double>(__fmul_rn(g, g));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const Leaf* __restrict__ table, int leaves, int64_t chunks,
             int64_t chunk, double* __restrict__ partials) {
  double acc = 0.0;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Leaf L = table[find_leaf(table, leaves, c)];
    const int64_t off = (c - L.chunk0) * chunk;
    const int64_t len = L.n - off < chunk ? L.n - off : chunk;
    const bool vec = (L.flags >> 16) & 1;
    if ((L.flags & 0xFF) == kBF16) acc += sumsq_span<kBF16>(L, off, len, vec);
    else acc += sumsq_span<kF32>(L, off, len, vec);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_finish(const double* __restrict__ partials, int n,
             float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = __double2float_rn(acc);
}

}  // namespace

// Sum of squares of every leaf's g (rows with g != 0, float32 or bf16)
// into *out (float32); `partials` holds `blocks` doubles.
extern "C" int adamw_sumsq_launch(const void* table, int leaves,
                                  long long chunks, int chunk, int blocks,
                                  void* partials, void* out, void* stream) {
  if (leaves < 0 || chunks < 0 || blocks < 1 || chunk <= 0 ||
      chunk % (kThreads * kVec) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 0)
    sumsq_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const Leaf*>(table), leaves, chunks, chunk,
        static_cast<double*>(partials));
  sumsq_finish<<<1, kThreads, 0, s>>>(static_cast<const double*>(partials),
                                      chunks > 0 ? blocks : 0,
                                      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One AdamW step of every leaf, in place.
extern "C" int adamw_update_launch(const void* table, int leaves,
                                   long long chunks, int chunk, int blocks,
                                   const void* scale, const void* lr,
                                   const void* bc1, const void* bc2, float b1,
                                   float omb1, float b2, float omb2,
                                   float eps, float wd, void* stream) {
  if (leaves < 0 || chunks < 0 || blocks < 1 || chunk <= 0 ||
      chunk % (kThreads * kVec) != 0)
    return (int)cudaErrorInvalidValue;
  if (chunks == 0) return 0;
  update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Leaf*>(table), leaves, chunks, chunk,
      static_cast<const float*>(scale), static_cast<const float*>(lr),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2), b1,
      omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
