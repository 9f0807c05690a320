// Device code shared by the port's CUDA kernels (kway_probe.cu, replay.cu):
// the one device copy of hash_u32 (repro_torch/core/hashing.py), the
// fingerprint, the policy scores (repro_torch/core/policies.py), the set
// probe and the stable victim order.
//
// Exactness: the scores are float32 as in the reference.  RANDOM converts
// the uint32 hash round-to-nearest, HYPERBOLIC divides with IEEE rounding
// (__fdiv_rn; the build never passes --use_fast_math), and the victim order
// is the stable ascending sort of the scores (ties to the lowest way).
//
// State lanes are int32 [S, ways] with EMPTY == -1 in `keys`.  None of these
// helpers reads through __ldg or a const __restrict__ pointer: the replay
// kernel writes the state it reads inside one launch.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rk {

constexpr int32_t kEmpty = -1;
constexpr int32_t kNoExpiry = 0x7FFFFFFF;
constexpr float kNegInf = -3.0e38f;
constexpr int kMaxWays = 128;

enum Policy { LRU = 0, LFU = 1, FIFO = 2, RANDOM = 3, HYPERBOLIC = 4 };

__device__ __forceinline__ uint32_t hash_u32(uint32_t k, uint32_t seed) {
  uint32_t x = (k + seed * 0x9E3779B1u) * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int32_t fingerprint(int32_t key) {
  return (int32_t)(hash_u32((uint32_t)key, 0xF19Eu) & 0xFFFFu);
}

// Victim score of one occupied way: lower evicts sooner.
template <int P>
__device__ __forceinline__ float score(int32_t key, int32_t a, int32_t b,
                                       int32_t now) {
  if (P == RANDOM) {
    return __uint2float_rn(hash_u32((uint32_t)key ^ (uint32_t)now, 0xBADAu));
  }
  if (P == HYPERBOLIC) {
    const int32_t age_i = (int32_t)((uint32_t)now - (uint32_t)b);
    const float age = __fadd_rn(__int2float_rn(age_i), 1.0f);
    return __fdiv_rn(__int2float_rn(a), age);
  }
  return __int2float_rn(a);  // LRU / LFU / FIFO: argmin meta_a
}

// Calls f(w) for w in [0, ways).  Up to 16 ways the loop is unrolled over
// MAXW so that per-way arrays indexed by w stay in registers.
template <int MAXW, typename F>
__device__ __forceinline__ void for_ways(int ways, F f) {
  if constexpr (MAXW <= 16) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < ways) f(w);
    }
  } else {
    for (int w = 0; w < ways; ++w) f(w);
  }
}

// First way of the row starting at `row` that holds `qk` (16-bit
// fingerprint pre-filter, confirmed on the full key), or -1.
__device__ __forceinline__ int probe_row(const int32_t* keys,
                                         const int32_t* fpr, int64_t row,
                                         int ways, int32_t qk) {
  const int32_t qfp = fingerprint(qk);
  for (int w = 0; w < ways; ++w) {
    const int32_t k = keys[row + w];
    if (k != kEmpty && fpr[row + w] == qfp && k == qk) return w;
  }
  return -1;
}

// Scores of one row at time `now`; empty ways score kNegInf (fill first).
template <int P, int MAXW>
__device__ __forceinline__ void row_scores(const int32_t* keys,
                                           const int32_t* ma,
                                           const int32_t* mb, int64_t row,
                                           int ways, int32_t now,
                                           float (&sc)[MAXW]) {
  for_ways<MAXW>(ways, [&](int w) {
    const int32_t k = keys[row + w];
    sc[w] = k == kEmpty ? kNegInf : score<P>(k, ma[row + w], mb[row + w], now);
  });
}

// emit(pos, w) for every way: pos is w's place in the stable ascending
// order of the scores, i.e. the worst-victim-first order.
template <int MAXW, typename Emit>
__device__ __forceinline__ void victim_order(const float (&sc)[MAXW],
                                             int ways, Emit emit) {
  for_ways<MAXW>(ways, [&](int w) {
    const float s = sc[w];
    int pos = 0;
    for_ways<MAXW>(ways, [&](int v) {
      pos += (sc[v] < s) || (v < w && sc[v] == s);
    });
    emit(pos, w);
  });
}

}  // namespace rk
