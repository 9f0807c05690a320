// Hopper kernels 1 and 2 of the port: the batched k-way set probe.
//
// Replaces the Pallas TPU kernels of repro/kernels/kway_probe.py:
//   kway_probe_launch        <- kway_probe / _probe_kernel (:109, :183)
//   kway_fused_probe_launch  <- kway_fused_probe / _fused_kernel (:251, :337)
//
// The TPU kernels pinned the whole state in VMEM and padded ways to the
// 128-lane register width.  Here the state stays in HBM (a production
// cache is far larger than shared memory; 24 MiB fits the 50 MB L2), ways
// are not padded, and one thread serves one query: it reads its set's
// `ways` keys and fingerprints, then the metadata it scores.  Bound: bytes.
// A query moves at most 4 rows of ways*4 B plus 12 B of inputs and writes
// 8 + 4*ways B; the row reads are random gathers, so the design reads each
// row once per query and keeps scores in registers (ways <= 16).
//
// Kernel 2 is two launches on one stream: (a) probe and apply the live
// hits' on_hit to a copy of meta_a with atomicMax (LRU: batch times grow
// in batch order, so the last sequential write is the max) or atomicAdd
// (LFU/HYPERBOLIC); integer max and sum commute, so the copy is exact in
// any order.  (b) needs all of (a): it scores the copy at the put-phase
// times and writes the full victim order.
//
// Each C entry returns cudaGetLastError() after its launches.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// MODE 0: (hit, way); 1: + victim way and key; 2: + full victim order.
template <int P, int MODE, int MAXW>
__global__ void probe_kernel(const int32_t* keys, const int32_t* fpr,
                             const int32_t* ma, const int32_t* mb,
                             const int32_t* sets, const int32_t* qkeys,
                             const int32_t* times, int B, int ways,
                             int32_t* hit, int32_t* way, int32_t* vway,
                             int32_t* vkey, int32_t* order) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int64_t row = (int64_t)sets[q] * ways;
  const int w0 = rk::probe_row(keys, fpr, row, ways, qkeys[q]);
  hit[q] = w0 >= 0;
  way[q] = w0 >= 0 ? w0 : 0;
  if constexpr (MODE > 0) {
    float sc[MAXW];
    rk::row_scores<P, MAXW>(keys, ma, mb, row, ways, times[q], sc);
    int best = 0;
    if constexpr (MODE == 1) {
      float bs = sc[0];
      rk::for_ways<MAXW>(ways, [&](int w) {
        if (sc[w] < bs) {
          bs = sc[w];
          best = w;
        }
      });
    } else {
      int32_t* out = order + (int64_t)q * ways;
      rk::victim_order<MAXW>(sc, ways, [&](int pos, int w) {
        out[pos] = w;
        if (pos == 0) best = w;
      });
    }
    vway[q] = best;
    vkey[q] = keys[row + best];
  }
}

template <int P>
__global__ void fused_hit_kernel(const int32_t* keys, const int32_t* fpr,
                                 int32_t* ma1, const int32_t* sets,
                                 const int32_t* qkeys,
                                 const int32_t* times_get, const uint8_t* en,
                                 int B, int ways, int32_t* hit, int32_t* way) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int64_t row = (int64_t)sets[q] * ways;
  const int w0 = rk::probe_row(keys, fpr, row, ways, qkeys[q]);
  hit[q] = w0 >= 0;
  way[q] = w0 >= 0 ? w0 : 0;
  if (w0 >= 0 && en[q]) {
    if (P == rk::LRU) atomicMax(&ma1[row + w0], times_get[q]);
    if (P == rk::LFU || P == rk::HYPERBOLIC) atomicAdd(&ma1[row + w0], 1);
  }
}

template <int P, int MAXW>
__global__ void fused_order_kernel(const int32_t* keys, const int32_t* ma1,
                                   const int32_t* mb, const int32_t* sets,
                                   const int32_t* times_put, int B, int ways,
                                   int32_t* order) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int64_t row = (int64_t)sets[q] * ways;
  float sc[MAXW];
  rk::row_scores<P, MAXW>(keys, ma1, mb, row, ways, times_put[q], sc);
  int32_t* out = order + (int64_t)q * ways;
  rk::victim_order<MAXW>(sc, ways, [&](int pos, int w) { out[pos] = w; });
}

template <int P, int MODE, int MAXW>
void launch_probe(const int32_t* keys, const int32_t* fpr, const int32_t* ma,
                  const int32_t* mb, const int32_t* sets,
                  const int32_t* qkeys, const int32_t* times, int B,
                  int ways, int32_t* hit, int32_t* way, int32_t* vway,
                  int32_t* vkey, int32_t* order, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  probe_kernel<P, MODE, MAXW><<<blocks, kThreads, 0, stream>>>(
      keys, fpr, ma, mb, sets, qkeys, times, B, ways, hit, way, vway, vkey,
      order);
}

template <int P, int MAXW>
void launch_fused(const int32_t* keys, const int32_t* fpr, int32_t* ma1,
                  const int32_t* mb, const int32_t* sets,
                  const int32_t* qkeys, const int32_t* times_get,
                  const int32_t* times_put, const uint8_t* en, int B,
                  int ways, int32_t* hit, int32_t* way, int32_t* order,
                  cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  fused_hit_kernel<P><<<blocks, kThreads, 0, stream>>>(
      keys, fpr, ma1, sets, qkeys, times_get, en, B, ways, hit, way);
  fused_order_kernel<P, MAXW><<<blocks, kThreads, 0, stream>>>(
      keys, ma1, mb, sets, times_put, B, ways, order);
}

template <int MODE, int MAXW>
int dispatch_probe_policy(int policy, const int32_t* keys,
                          const int32_t* fpr, const int32_t* ma,
                          const int32_t* mb, const int32_t* sets,
                          const int32_t* qkeys, const int32_t* times, int B,
                          int ways, int32_t* hit, int32_t* way,
                          int32_t* vway, int32_t* vkey, int32_t* order,
                          cudaStream_t s) {
#define RK_PROBE(P)                                                          \
  launch_probe<P, MODE, MAXW>(keys, fpr, ma, mb, sets, qkeys, times, B,     \
                              ways, hit, way, vway, vkey, order, s)
  switch (policy) {
    case rk::LRU: RK_PROBE(rk::LRU); break;
    case rk::LFU: RK_PROBE(rk::LFU); break;
    case rk::FIFO: RK_PROBE(rk::FIFO); break;
    case rk::RANDOM: RK_PROBE(rk::RANDOM); break;
    case rk::HYPERBOLIC: RK_PROBE(rk::HYPERBOLIC); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RK_PROBE
  return 0;
}

template <int MAXW>
int dispatch_fused_policy(int policy, const int32_t* keys,
                          const int32_t* fpr, int32_t* ma1,
                          const int32_t* mb, const int32_t* sets,
                          const int32_t* qkeys, const int32_t* tg,
                          const int32_t* tp, const uint8_t* en, int B,
                          int ways, int32_t* hit, int32_t* way,
                          int32_t* order, cudaStream_t s) {
#define RK_FUSED(P)                                                          \
  launch_fused<P, MAXW>(keys, fpr, ma1, mb, sets, qkeys, tg, tp, en, B,     \
                        ways, hit, way, order, s)
  switch (policy) {
    case rk::LRU: RK_FUSED(rk::LRU); break;
    case rk::LFU: RK_FUSED(rk::LFU); break;
    case rk::FIFO: RK_FUSED(rk::FIFO); break;
    case rk::RANDOM: RK_FUSED(rk::RANDOM); break;
    case rk::HYPERBOLIC: RK_FUSED(rk::HYPERBOLIC); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RK_FUSED
  return 0;
}

}  // namespace

extern "C" int kway_probe_launch(const void* keys, const void* fpr,
                                 const void* ma, const void* mb,
                                 const void* sets, const void* qkeys,
                                 const void* times, int B, int ways,
                                 int policy, int mode, void* hit, void* way,
                                 void* vway, void* vkey, void* order,
                                 void* stream) {
  if (B <= 0) return 0;
  if (ways < 1 || ways > rk::kMaxWays || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  auto k = (const int32_t*)keys;
  auto f = (const int32_t*)fpr;
  auto a = (const int32_t*)ma;
  auto b = (const int32_t*)mb;
  auto st = (const int32_t*)sets;
  auto qk = (const int32_t*)qkeys;
  auto tm = (const int32_t*)times;
  auto h = (int32_t*)hit;
  auto w = (int32_t*)way;
  auto vw = (int32_t*)vway;
  auto vk = (int32_t*)vkey;
  auto o = (int32_t*)order;
  auto s = (cudaStream_t)stream;
  int rc;
  if (mode == 0) {  // no scoring: one instantiation serves every policy
    rc = dispatch_probe_policy<0, 16>(rk::LRU, k, f, a, b, st, qk, tm, B, ways,
                                      h, w, vw, vk, o, s);
  } else if (mode == 1) {
    rc = ways <= 16 ? dispatch_probe_policy<1, 16>(policy, k, f, a, b, st, qk,
                                                   tm, B, ways, h, w, vw, vk,
                                                   o, s)
                    : dispatch_probe_policy<1, rk::kMaxWays>(
                          policy, k, f, a, b, st, qk, tm, B, ways, h, w, vw,
                          vk, o, s);
  } else {
    rc = ways <= 16 ? dispatch_probe_policy<2, 16>(policy, k, f, a, b, st, qk,
                                                   tm, B, ways, h, w, vw, vk,
                                                   o, s)
                    : dispatch_probe_policy<2, rk::kMaxWays>(
                          policy, k, f, a, b, st, qk, tm, B, ways, h, w, vw,
                          vk, o, s);
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" int kway_fused_probe_launch(const void* keys, const void* fpr,
                                       void* ma1, const void* mb,
                                       const void* sets, const void* qkeys,
                                       const void* times_get,
                                       const void* times_put, const void* en,
                                       int B, int ways, int policy,
                                       void* hit, void* way, void* order,
                                       void* stream) {
  if (B <= 0) return 0;
  if (ways < 1 || ways > rk::kMaxWays) return (int)cudaErrorInvalidValue;
  auto k = (const int32_t*)keys;
  auto f = (const int32_t*)fpr;
  auto a1 = (int32_t*)ma1;
  auto b = (const int32_t*)mb;
  auto st = (const int32_t*)sets;
  auto qk = (const int32_t*)qkeys;
  auto tg = (const int32_t*)times_get;
  auto tp = (const int32_t*)times_put;
  auto e = (const uint8_t*)en;
  auto h = (int32_t*)hit;
  auto w = (int32_t*)way;
  auto o = (int32_t*)order;
  auto s = (cudaStream_t)stream;
  const int rc =
      ways <= 16
          ? dispatch_fused_policy<16>(policy, k, f, a1, b, st, qk, tg, tp, e,
                                      B, ways, h, w, o, s)
          : dispatch_fused_policy<rk::kMaxWays>(policy, k, f, a1, b, st, qk,
                                                tg, tp, e, B, ways, h, w, o,
                                                s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
