// Hopper kernels 1 and 2 of the port: the batched k-way set probe, with the
// route inside.
//
// Replaces the Pallas TPU kernels of repro/kernels/kway_probe.py:
//   kway_probe_launch        <- kway_probe / _probe_kernel (:109, :183)
//   kway_fused_probe_launch  <- kway_fused_probe / _fused_kernel (:251, :337)
//
// The TPU kernels took routed keys, pinned the whole state in VMEM and
// padded ways to the 128-lane register width; kernel 2 applied the hits to
// a VMEM copy of meta_a.  Here each entry is one launch that takes the raw
// int32 key lanes and does everything the ops layer built around the
// kernel in torch: sanitize (EMPTY -> 0xFFFFFFFE), the set index
// (rk::hash_u32, as kernel 4 does), the times clock + i (and clock + B + i
// for kernel 2's put phase), read from the state's clock on the card.  It
// writes every output into one int32 buffer (layout below) in the dtypes
// kway.apply_* consume: sets and ways as int64, hits as bytes (bool).
//
// A lane group of G lanes (the power of two at or above min(ways, 32))
// owns a query's row: lane l holds ways l, l+G, ... (J = ways/32 of them
// above 32 ways), so the row is read in coalesced loads.  The hit is the
// lowest matching way (a ballot and __ffs), as the reference's
// min(where(eq, lane, LANES)).  A way's place in the victim order is the
// count of ways that sort before it (a lower score, or a tie at a lower
// way), worst victim first; empty ways score -inf.  Scores are float32 as
// in the reference, with IEEE division (no --use_fast_math).
//
// Kernel 2 needs each query's order scored on meta_a after ALL the batch's
// live hits, and must not write the state.  All queries of one set go to
// one CTA: CTA c takes the queries whose set is c mod C, found by scanning
// the batch's keys (each CTA reads and hashes all B of them, and lists its
// own while they fit shared memory).  It groups them by set with a hash
// table (shared memory, or its own region of the global scratch when it
// has more than kSmemQueries queries, and then it hashes the batch a second
// time to list them), and one lane group per set reads the row once,
// applies the set's live hits to meta_a in registers (LRU: the max of
// clock + i; LFU/HYPERBOLIC: the count; max and sum commute, so the order
// within a group does not matter), then writes each query's order at its
// own put time.  No copy of meta_a: the state's bytes are O(B), not
// O(S * ways).  The scan is not: C = min(B/8, 256, S) CTAs each read and
// hash the whole batch, O(B * C) hashes (the keys come from L2 after the
// first CTA), up to 256 B hashes above 2048 queries.
//
// Bound: bytes, at the reference's widths.  Kernel 1 reads 4 B of raw key
// per query and, of each row it probes, the lanes its policy reads; kernel
// 2 also the enable byte.  Both write 4 B of key, 4 B of set, 4 B of way
// and 1 B of hit per query, and the victim (8 B) or the order (4 * ways B).
// The row reads are random gathers; each row is read once per query
// (kernel 1) or once per set (kernel 2).  The int64 sets and ways (4 B
// more each) are this design's cost, not the bound's.
//
// Each C entry returns cudaGetLastError() after its launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// kernel 2: a CTA groups up to kSmemQueries queries in shared memory; with
// more, in its region of the global scratch (kScratchPerQuery ints a query
// of the batch: hash table 3 x H < 12 n, 3 lists of n)
constexpr int kSmemQueries = 512;
constexpr int kScratchPerQuery = 15;
constexpr int kMaxCtas = 256;
constexpr int kScanAhead = 8;

enum Mode { HITS = 0, VICTIM = 1, ORDER = 2, FUSED = 3 };

#ifdef KWAY_PHASE_CLOCKS
// A measurement build only (chip_smoke.py builds it beside the library):
// each CTA of kernel 2 stamps clock64() at its start and at the end of
// each of its three phases, after a barrier; kway_phase_clocks reads them.
__device__ long long g_phase_clock[kMaxCtas][4];
#define PHASE_CLOCK(k)                                              \
  do {                                                              \
    __syncthreads();                                                \
    if (threadIdx.x == 0) g_phase_clock[blockIdx.x][k] = clock64(); \
  } while (0)
#else
#define PHASE_CLOCK(k) \
  do {                 \
  } while (0)
#endif

struct Lanes {
  const int32_t* keys;
  const int32_t* fpr;
  const int32_t* ma;
  const int32_t* mb;
};

// The output buffer, in int32 words: sets [2B] (int64), way [2B] (int64),
// vway [2B] (int64; VICTIM, ORDER), qk [B], vkey [B] (VICTIM, ORDER),
// order [B * ways] (ORDER, FUSED), hit [ceil(B/4)] (bytes), scratch
// [kScratchPerQuery * B] (FUSED).  kernels/kway_probe.py has the same.
struct Out {
  int64_t* sets;
  int64_t* way;
  int64_t* vway;
  int32_t* qk;
  int32_t* vkey;
  int32_t* order;
  uint8_t* hit;
  int32_t* scratch;
};

Out layout(int32_t* p, int B, int ways, int mode) {
  const bool victims = mode == VICTIM || mode == ORDER;
  const int64_t b = B;
  Out o{};
  o.sets = (int64_t*)p;
  p += 2 * b;
  o.way = (int64_t*)p;
  p += 2 * b;
  if (victims) {
    o.vway = (int64_t*)p;
    p += 2 * b;
  }
  o.qk = p;
  p += b;
  if (victims) {
    o.vkey = p;
    p += b;
  }
  if (mode == ORDER || mode == FUSED) {
    o.order = p;
    p += b * ways;
  }
  o.hit = (uint8_t*)p;
  p += (b + 3) / 4;
  if (mode == FUSED) o.scratch = p;
  return o;
}

__device__ __forceinline__ int32_t sanitize(int32_t k) {
  return k == rk::kEmpty ? -2 : k;  // EMPTY folds onto 0xFFFFFFFE
}

__device__ __forceinline__ uint32_t set_of(int32_t qk, uint32_t seed,
                                           int S) {
  return rk::hash_u32((uint32_t)qk, seed) & (uint32_t)(S - 1);
}

__device__ __forceinline__ int32_t add32(int32_t a, int64_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);  // int32 wrap, as torch
}

// The G lanes of one lane group: its mask in the warp and its first lane.
template <int G>
struct Group {
  int gl;         // lane within the group
  int base;       // first lane of the group in the warp
  unsigned mask;  // the group's lanes
  __device__ Group() {
    const int lane = threadIdx.x & 31;
    gl = lane & (G - 1);
    base = lane & ~(G - 1);
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << base;
  }
  __device__ unsigned ballot(bool p) const {
    const unsigned b = __ballot_sync(mask, p) >> base;
    return G == 32 ? b : b & ((1u << G) - 1);
  }
};

// One set's row as a lane group holds it: lane gl has ways gl + j*G.
template <int G, int J>
struct Row {
  int32_t key[J], fp[J], a[J], b[J];
  float sc[J];
  int pos[J];

  __device__ void load(const Lanes& L, int64_t row, int ways, int gl,
                       bool meta_a, bool meta_b) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int w = j * G + gl;
      const bool in = w < ways;
      key[j] = in ? L.keys[row + w] : rk::kEmpty;
      fp[j] = in ? L.fpr[row + w] : 0;
      a[j] = in && meta_a ? L.ma[row + w] : 0;
      b[j] = in && meta_b ? L.mb[row + w] : 0;
    }
  }

  // Lowest way holding qk (fingerprint pre-filter, full-key confirm), or
  // -1; the same in every lane of the group.
  __device__ int probe(const Group<G>& g, int32_t qk, int ways) const {
    const int32_t qfp = rk::fingerprint(qk);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const bool m = j * G + g.gl < ways && key[j] != rk::kEmpty &&
                     fp[j] == qfp && key[j] == qk;
      const unsigned bal = g.ballot(m);
      if (bal) return j * G + __ffs(bal) - 1;
    }
    return -1;
  }

  // pos[j]: the place of way gl + j*G in the worst-victim-first order at
  // time `now` (the count of ways with a lower score, or a tie at a lower
  // way).
  template <int P>
  __device__ void order(const Group<G>& g, int ways, int32_t now) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sc[j] = key[j] == rk::kEmpty ? rk::kNegInf
                                   : rk::score<P>(key[j], a[j], b[j], now);
      pos[j] = 0;
    }
#pragma unroll
    for (int jv = 0; jv < J; ++jv) {
      for (int lv = 0; lv < G; ++lv) {
        const int v = jv * G + lv;
        const float s = __shfl_sync(g.mask, sc[jv], lv, G);
        if (v >= ways) break;  // the same in every lane of the group
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int w = j * G + g.gl;
          pos[j] += (s < sc[j]) || (s == sc[j] && v < w);
        }
      }
    }
  }
};

template <int P>
constexpr bool kTimed = P == rk::RANDOM || P == rk::HYPERBOLIC;

// Kernel 1: one lane group per query.
template <int P, int G, int J>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(Lanes L, const int32_t* qraw, const int32_t* clock, int S,
                 uint32_t seed, int B, int ways, int mode, Out o) {
  const Group<G> g;
  const int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  if (q >= B) return;  // a whole group leaves together
  const int32_t qk = sanitize(qraw[q]);
  const uint32_t s = set_of(qk, seed, S);
  const int64_t row = (int64_t)s * ways;
  Row<G, J> r;
  r.load(L, row, ways, g.gl, mode != HITS && P != rk::RANDOM,
         mode != HITS && P == rk::HYPERBOLIC);
  const int w0 = r.probe(g, qk, ways);
  if (g.gl == 0) {
    o.qk[q] = qk;
    o.sets[q] = s;
    o.hit[q] = w0 >= 0;
    o.way[q] = w0 >= 0 ? w0 : 0;
  }
  if (mode == HITS) return;
  r.template order<P>(g, ways, add32(*clock, q));
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int w = j * G + g.gl;
    if (w >= ways) continue;
    if (r.pos[j] == 0) {
      o.vway[q] = w;
      o.vkey[q] = r.key[j];
    }
    if (mode == ORDER) o.order[q * ways + r.pos[j]] = w;
  }
}

__device__ __forceinline__ int block_sum(int v, int* sh) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sh[w];
  return t;
}

// pos[i] = cnt[0] + ... + cnt[i-1] for i < H, by the whole block.
__device__ void block_exclusive_scan(const int32_t* cnt, int32_t* pos,
                                     int H, int* sh) {
  const int per = (H + kThreads - 1) / kThreads;
  const int lo = min(H, (int)threadIdx.x * per);
  const int hi = min(H, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  const int lane = threadIdx.x & 31;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  __syncthreads();
  if (lane == 31) sh[threadIdx.x >> 5] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) run += sh[w];
  for (int i = lo; i < hi; ++i) {
    pos[i] = run;
    run += cnt[i];
  }
  __syncthreads();
}

// f(i, raw key i) for this thread's queries i of the batch, the keys
// loaded kScanAhead at a time: every CTA of kernel 2 reads the whole batch,
// and one load at a time leaves the scan waiting on L2.
template <class F>
__device__ __forceinline__ void scan_batch(const int32_t* qraw, int B, F f) {
  for (int i0 = threadIdx.x; i0 < B; i0 += kScanAhead * kThreads) {
    int32_t k[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const int i = i0 + u * kThreads;
      k[u] = i < B ? __ldg(qraw + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const int i = i0 + u * kThreads;
      if (i < B) f(i, k[u]);
    }
  }
}

// Kernel 2: CTA c takes the sets congruent to c mod C (C = gridDim.x).
template <int P, int G, int J>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(Lanes L, const int32_t* qraw, const uint8_t* en,
                 const int32_t* clock, int S, uint32_t seed, int B, int ways,
                 Out o) {
  // the hash table (3 x H <= 6 x kSmemQueries ints), then the CTA's
  // queries, their sets (then slots) and their list by slot
  __shared__ int32_t s_tab[6 * kSmemQueries + 3 * kSmemQueries];
  __shared__ int s_red[kWarps];
  __shared__ int s_items;
  const int c = blockIdx.x;
  const unsigned cmask = gridDim.x - 1;
  PHASE_CLOCK(0);

  // 1. this CTA's queries: write their keys and sets, list them (while
  //    they fit shared memory), count them and the queries of the CTAs
  //    before it (which place its region of the global scratch)
  int32_t* s_list = s_tab + 6 * kSmemQueries;
  if (threadIdx.x == 0) s_items = 0;
  __syncthreads();
  int lt = 0;
  scan_batch(qraw, B, [&](int i, int32_t raw) {
    const int32_t k = sanitize(raw);
    const uint32_t s = set_of(k, seed, S);
    const int cls = (int)(s & cmask);
    lt += cls < c;
    if (cls == c) {
      o.qk[i] = k;
      o.sets[i] = s;
      const int p = atomicAdd(&s_items, 1);
      if (p < kSmemQueries) {
        s_list[p] = i;
        s_list[kSmemQueries + p] = (int32_t)s;
      }
    }
  });
  const int n_lt = block_sum(lt, s_red);  // its barriers publish s_items
  const int n = s_items;
  PHASE_CLOCK(1);
  if (n == 0) return;

  // 2. group them by set: a hash table of H >= 2n slots (set, count,
  //    position), then the queries listed slot by slot
  int H = 2;
  while (H < 2 * n) H <<= 1;
  const bool in_smem = n <= kSmemQueries;
  int32_t* base =
      in_smem ? s_tab : o.scratch + (int64_t)kScratchPerQuery * n_lt;
  int32_t* tab_set = base;
  int32_t* tab_cnt = base + H;
  int32_t* tab_pos = base + 2 * H;
  int32_t* item_q = in_smem ? s_list : base + 3 * H;
  int32_t* item_slot = item_q + (in_smem ? kSmemQueries : n);
  int32_t* glist = item_slot + (in_smem ? kSmemQueries : n);
  for (int t = threadIdx.x; t < H; t += kThreads) {
    tab_set[t] = -1;
    tab_cnt[t] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) s_items = 0;
  // the slot of set s (claimed on first sight), its count raised by one
  auto insert = [&](uint32_t s) {
    int h = (int)(rk::hash_u32(s, 0x5E75u) & (unsigned)(H - 1));
    for (;;) {
      const int32_t old = atomicCAS(&tab_set[h], -1, (int32_t)s);
      if (old == -1 || old == (int32_t)s) break;
      h = (h + 1) & (H - 1);
    }
    atomicAdd(&tab_cnt[h], 1);
    return h;
  };
  if (in_smem) {
    // the list of step 1: each query's set becomes its slot
    for (int p = threadIdx.x; p < n; p += kThreads) {
      item_slot[p] = insert((uint32_t)item_slot[p]);
    }
  } else {
    // more queries than shared memory lists: find them again (each CTA
    // hashes the batch twice)
    __syncthreads();
    scan_batch(qraw, B, [&](int i, int32_t raw) {
      const uint32_t s = set_of(sanitize(raw), seed, S);
      if ((s & cmask) != (unsigned)c) return;
      const int h = insert(s);
      const int p = atomicAdd(&s_items, 1);
      item_q[p] = i;
      item_slot[p] = h;
    });
  }
  __syncthreads();
  block_exclusive_scan(tab_cnt, tab_pos, H, s_red);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    glist[atomicAdd(&tab_pos[item_slot[p]], 1)] = item_q[p];
  }
  __syncthreads();  // tab_pos[h] is now the end of slot h's queries
  PHASE_CLOCK(2);

  // 3. one lane group per set: the row once, the set's live hits applied
  //    to meta_a in registers, each query's order at its own put time
  const Group<G> g;
  const int32_t clock0 = *clock;
  for (int h = threadIdx.x / G; h < H; h += kThreads / G) {
    const int cnt = tab_cnt[h];
    if (cnt == 0) continue;
    const int end = tab_pos[h];
    const int64_t row = (int64_t)tab_set[h] * ways;
    Row<G, J> r;
    r.load(L, row, ways, g.gl, P != rk::RANDOM, P == rk::HYPERBOLIC);
    for (int t = end - cnt; t < end; ++t) {
      const int q = glist[t];
      const int w0 = r.probe(g, o.qk[q], ways);
      if (g.gl == 0) {
        o.hit[q] = w0 >= 0;
        o.way[q] = w0 >= 0 ? w0 : 0;
      }
      if (w0 < 0 || (en != nullptr && !en[q])) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j * G + g.gl != w0) continue;
        if (P == rk::LRU) r.a[j] = max(r.a[j], add32(clock0, q));
        if (P == rk::LFU || P == rk::HYPERBOLIC) r.a[j] = add32(r.a[j], 1);
      }
    }
    if (!kTimed<P>) r.template order<P>(g, ways, 0);
    for (int t = end - cnt; t < end; ++t) {
      const int q = glist[t];
      if (kTimed<P>) r.template order<P>(g, ways, add32(clock0, (int64_t)B + q));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int w = j * G + g.gl;
        if (w < ways) o.order[(int64_t)q * ways + r.pos[j]] = w;
      }
    }
  }
  PHASE_CLOCK(3);
}

struct Launch {
  Lanes L;
  const int32_t* qraw;
  const uint8_t* en;
  const int32_t* clock;
  int S, B, ways, mode;
  uint32_t seed;
  Out o;
  cudaStream_t s;
};

template <int P, int G, int J>
void launch(const Launch& a) {
  if (a.mode == FUSED) {
    // about 8 queries a CTA, at most kMaxCtas, and no more CTAs than sets
    int ctas = 1;
    while (ctas * 2 <= a.B / 8 && ctas * 2 <= kMaxCtas && ctas * 2 <= a.S) {
      ctas *= 2;
    }
    fused_kernel<P, G, J><<<ctas, kThreads, 0, a.s>>>(
        a.L, a.qraw, a.en, a.clock, a.S, a.seed, a.B, a.ways, a.o);
  } else {
    const int64_t threads = (int64_t)a.B * G;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
    probe_kernel<P, G, J><<<blocks, kThreads, 0, a.s>>>(
        a.L, a.qraw, a.clock, a.S, a.seed, a.B, a.ways, a.mode, a.o);
  }
}

template <int P>
void launch_ways(const Launch& a) {
  if (a.ways > 64) return launch<P, 32, 4>(a);
  if (a.ways > 32) return launch<P, 32, 2>(a);
  if (a.ways > 16) return launch<P, 32, 1>(a);
  if (a.ways > 8) return launch<P, 16, 1>(a);
  if (a.ways > 4) return launch<P, 8, 1>(a);
  if (a.ways > 2) return launch<P, 4, 1>(a);
  if (a.ways > 1) return launch<P, 2, 1>(a);
  return launch<P, 1, 1>(a);
}

int run(int policy, const Launch& a) {
  if (a.B <= 0) return 0;
  if (a.ways < 1 || a.ways > rk::kMaxWays || a.S < 1 || (a.S & (a.S - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (policy) {
    case rk::LRU: launch_ways<rk::LRU>(a); break;
    case rk::LFU: launch_ways<rk::LFU>(a); break;
    case rk::FIFO: launch_ways<rk::FIFO>(a); break;
    case rk::RANDOM: launch_ways<rk::RANDOM>(a); break;
    case rk::HYPERBOLIC: launch_ways<rk::HYPERBOLIC>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kway_probe_launch(const void* keys, const void* fpr,
                                 const void* ma, const void* mb,
                                 const void* qkeys, const void* clock, int S,
                                 int seed, int B, int ways, int policy,
                                 int mode, void* out, void* stream) {
  if (mode < HITS || mode > ORDER) return (int)cudaErrorInvalidValue;
  Launch a{{(const int32_t*)keys, (const int32_t*)fpr, (const int32_t*)ma,
            (const int32_t*)mb},
           (const int32_t*)qkeys, nullptr, (const int32_t*)clock, S, B, ways,
           mode, (uint32_t)seed, layout((int32_t*)out, B, ways, mode),
           (cudaStream_t)stream};
  return run(policy, a);
}

extern "C" int kway_fused_probe_launch(const void* keys, const void* fpr,
                                       const void* ma, const void* mb,
                                       const void* qkeys, const void* en,
                                       const void* clock, int S, int seed,
                                       int B, int ways, int policy, void* out,
                                       void* stream) {
  Launch a{{(const int32_t*)keys, (const int32_t*)fpr, (const int32_t*)ma,
            (const int32_t*)mb},
           (const int32_t*)qkeys, (const uint8_t*)en, (const int32_t*)clock,
           S, B, ways, FUSED, (uint32_t)seed,
           layout((int32_t*)out, B, ways, FUSED), (cudaStream_t)stream};
  return run(policy, a);
}

#ifdef KWAY_PHASE_CLOCKS
// Zero the stamps (reset != 0), or copy them to `host` (kMaxCtas x 4 int64).
extern "C" int kway_phase_clocks(void* host, int reset) {
  static const long long zero[kMaxCtas][4] = {};
  return (int)(reset ? cudaMemcpyToSymbol(g_phase_clock, zero, sizeof zero)
                     : cudaMemcpyFromSymbol(host, g_phase_clock,
                                            sizeof zero));
}
#endif
