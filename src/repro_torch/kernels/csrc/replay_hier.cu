// Hopper kernel 4 of the port: replay through the exclusive L1-over-L2
// hierarchy in ONE launch.
//
// Replaces the Pallas TPU kernel repro/kernels/replay.py:
// replay_hierarchical / _hier_replay_kernel (:652, :916).  The TPU kernel
// pinned a packed L1 in VMEM and DMA'd one packed L2 row at a time, with a
// scalar mailbox inside each row (a device against XLA's copy elision).
// None of that layout is carried over: both tiers stay in HBM as ordinary
// [S, ways] int32 lanes (+ the optional expiry lane), and scalars travel in
// registers.  At the full-size configuration the L1 is 192 KiB and the L2
// 24 MiB, so both sit in the 50 MB L2 cache.
//
// The semantics are sequential per lane (lane i sees lane i-1's moves;
// core/hierarchy.py), so this first kernel is ONE warp that walks the T*B
// lanes in order.  It routes each key itself: the salted L1 set s1, the L2
// set s2, and in phase D the demoted key's L2 set, all with one hash.
// Thread `l` of the warp owns ways l, l+32, l+64, l+96 of whatever row it
// works on; every element of a tier is only ever read and written by its
// owner thread, so program order alone orders the accesses and no barrier
// is needed.  Per lane:
//   A. load the L1 row s1 into registers (scrubbed at the chunk-exit
//      horizon with TTLs), probe it: a __ballot_sync of the key match and
//      __ffs give the lowest matching way; an enabled hit applies on_hit;
//   B. load and probe the L2 row s2 the same way (hit2 raw; l2_hit =
//      ~hit1 & hit2); the hit entry's value, metadata and deadline are
//      broadcast with __shfl_sync; an enabled L2 hit clears the slot
//      (promote) or updates it in place;
//   C. an enabled full miss (or a promotion) takes the L1 row's victim at
//      t_put: a warp min-reduce of (score, way), ties to the lowest way; the
//      displaced entry is broadcast and the insert written by its owner;
//   D. with demote, the displaced entry goes to the victim of ITS OWN L2
//      set (re-loaded after phase B's stores, so the aliasing case sees the
//      post-promote row).  With TTLs, phase D's row is fetched and scrubbed
//      even when nothing is demoted, as the reference does.
// An eviction counts when an entry leaves both tiers.  There is no final
// full scrub: the hierarchy's scrub is lazy only.
//
// Bound: bytes (the key and enable streams, the lanes the policy reads of
// every L1 and L2 row the run touches, and the rows it writes), but each request is a chain of two
// or more dependent L2-cache round trips (L1/L2 row, then the demotion
// row), walked by one warp on 1 of 132 SMs: the chain, not bytes, limits
// this design.  The state is written inside the launch, so it is never read
// through __ldg or a const __restrict__ pointer.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNJ = rk::kMaxWays / 32;  // ways per thread

struct Tier {
  int32_t *keys, *fpr, *vals, *ma, *mb, *exp;  // exp null: no expiry lane
  int ways;
};

// One set row in registers: way w = lane + 32*j lives in slot j of thread
// `lane`; slots past `ways` hold EMPTY and never match or win.
struct Row {
  int32_t k[kNJ], f[kNJ], v[kNJ], a[kNJ], b[kNJ], e[kNJ];
  int64_t base;  // flat index of way 0
};

__device__ __forceinline__ void load_row(const Tier& tr, int64_t set,
                                         int lane, Row& r) {
  r.base = set * tr.ways;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int w = lane + 32 * j;
    if (w < tr.ways) {
      const int64_t x = r.base + w;
      r.k[j] = tr.keys[x];
      r.f[j] = tr.fpr[x];
      r.v[j] = tr.vals[x];
      r.a[j] = tr.ma[x];
      r.b[j] = tr.mb[x];
      r.e[j] = tr.exp ? tr.exp[x] : rk::kNoExpiry;
    } else {
      r.k[j] = rk::kEmpty;
      r.f[j] = r.v[j] = r.a[j] = r.b[j] = 0;
      r.e[j] = rk::kNoExpiry;
    }
  }
}

// Store way w = lane + 32*j of the row (owner thread only).
__device__ __forceinline__ void store_way(const Tier& tr, const Row& r,
                                          int lane, int j) {
  const int64_t x = r.base + lane + 32 * j;
  tr.keys[x] = r.k[j];
  tr.fpr[x] = r.f[j];
  tr.vals[x] = r.v[j];
  tr.ma[x] = r.a[j];
  tr.mb[x] = r.b[j];
  if (tr.exp) tr.exp[x] = r.e[j];
}

// Lazy expiry scrub of a fetched row at `horizon` (reclaim, not eviction).
__device__ __forceinline__ void scrub(const Tier& tr, Row& r, int lane,
                                      int32_t horizon) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    if (lane + 32 * j < tr.ways && r.k[j] != rk::kEmpty &&
        r.e[j] <= horizon) {
      r.k[j] = rk::kEmpty;
      r.f[j] = 0;
      r.v[j] = 0;
      r.a[j] = 0;
      r.b[j] = 0;
      r.e[j] = rk::kNoExpiry;
      store_way(tr, r, lane, j);
    }
  }
}

// Lowest way holding `qk` (fingerprint pre-filter, full-key confirm), or -1.
__device__ __forceinline__ int probe(const Row& r, int32_t qk, int32_t fp) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const bool m = r.k[j] != rk::kEmpty && r.f[j] == fp && r.k[j] == qk;
    const unsigned ballot = __ballot_sync(kFull, m);
    if (ballot) return 32 * j + __ffs(ballot) - 1;
  }
  return -1;
}

// Policy victim at `now`: the lowest way of the least score (empty ways
// score kNegInf), by a warp min-reduce of (score, way).
template <int P>
__device__ __forceinline__ int victim(const Row& r, int ways, int lane,
                                      int32_t now) {
  float best = __int_as_float(0x7f800000);  // +inf
  int bw = 1 << 30;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int w = lane + 32 * j;
    if (w < ways) {
      const float s = r.k[j] == rk::kEmpty
                          ? rk::kNegInf
                          : rk::score<P>(r.k[j], r.a[j], r.b[j], now);
      if (s < best || bw == (1 << 30)) {
        best = s;
        bw = w;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFull, best, off);
    const int ow = __shfl_xor_sync(kFull, bw, off);
    if (os < best || (os == best && ow < bw)) {
      best = os;
      bw = ow;
    }
  }
  return bw;
}

// The value of way w in lane array `arr`, broadcast from its owner.
__device__ __forceinline__ int32_t bcast(const int32_t (&arr)[kNJ], int w) {
  int32_t x = 0;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    if (j == (w >> 5)) x = arr[j];
  }
  return __shfl_sync(kFull, x, w & 31);
}

// on_hit's meta_a (meta_b is unchanged by every policy's on_hit)
template <int P>
__device__ __forceinline__ int32_t hit_a(int32_t a, int32_t now) {
  return P == rk::LRU ? now
         : (P == rk::LFU || P == rk::HYPERBOLIC)
             ? (int32_t)((uint32_t)a + 1u)
             : a;
}

// on_insert's (meta_a, meta_b)
template <int P>
__device__ __forceinline__ int32_t insert_a(int32_t now) {
  return (P == rk::LRU || P == rk::FIFO) ? now : P == rk::RANDOM ? 0 : 1;
}

template <int P>
__device__ __forceinline__ int32_t insert_b(int32_t now) {
  return P == rk::HYPERBOLIC ? now : 0;
}

template <int P, bool TTL, bool PROMOTE, bool DEMOTE>
__global__ void __launch_bounds__(32, 1)
    hier_kernel(Tier l1, Tier l2, const int32_t* clock0, const int32_t* qk,
                const uint8_t* en, const int32_t* ttl, int T, int B,
                int l1_sets, int l2_sets, uint32_t seed1, uint32_t seed2,
                int32_t* hits_out, int32_t* evs_out) {
  const int lane = threadIdx.x;
  const uint32_t c0 = (uint32_t)clock0[0];
  const uint32_t b2 = 2u * (uint32_t)B;
  const uint32_t l1_mask = (uint32_t)l1_sets - 1u;
  const uint32_t l2_mask = (uint32_t)l2_sets - 1u;

  for (int t = 0; t < T; ++t) {
    const uint32_t base = c0 + b2 * (uint32_t)t;
    const int32_t horizon = (int32_t)(base + b2);
    int hits = 0, evs = 0;
    for (int i = 0; i < B; ++i) {
      const int64_t x = (int64_t)t * B + i;
      const int32_t q = qk[x];
      const int32_t fp = rk::fingerprint(q);
      const bool live = en[x] != 0;
      const int32_t t_get = (int32_t)(base + (uint32_t)i);
      const int32_t t_put = (int32_t)(base + (uint32_t)B + (uint32_t)i);
      int32_t dl = rk::kNoExpiry;
      if (TTL) {
        const int32_t tt = ttl[x];
        if (tt > 0) dl = (int32_t)((uint32_t)horizon + (uint32_t)tt);
      }
      Row r1, r2;
      load_row(l1, rk::hash_u32((uint32_t)q, seed1) & l1_mask, lane, r1);
      load_row(l2, rk::hash_u32((uint32_t)q, seed2) & l2_mask, lane, r2);
      if (TTL) {
        scrub(l1, r1, lane, horizon);
        scrub(l2, r2, lane, horizon);
      }

      // ---- A: L1 hit
      const int w1 = probe(r1, q, fp);
      const bool hit1 = w1 >= 0;
      if (hit1 && live && P != rk::FIFO && P != rk::RANDOM &&
          lane == (w1 & 31)) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          if (j == (w1 >> 5)) {
            r1.a[j] = hit_a<P>(r1.a[j], t_get);
            l1.ma[r1.base + w1] = r1.a[j];
          }
        }
      }

      // ---- B: L2 hit, promoted or updated in place
      const int w2 = probe(r2, q, fp);
      const bool l2_hit = !hit1 && w2 >= 0;
      int32_t pval = 0, pa = 0, pb = 0, pexp = rk::kNoExpiry;
      if (l2_hit) {
        pval = bcast(r2.v, w2);
        pa = hit_a<P>(bcast(r2.a, w2), t_get);
        pb = bcast(r2.b, w2);
        pexp = bcast(r2.e, w2);
        if (live && lane == (w2 & 31)) {
          const int64_t y = r2.base + w2;
          if (PROMOTE) {
            l2.keys[y] = rk::kEmpty;
            l2.fpr[y] = 0;
            l2.vals[y] = 0;
            l2.ma[y] = 0;
            l2.mb[y] = 0;
            if (l2.exp) l2.exp[y] = rk::kNoExpiry;
          } else {
            l2.ma[y] = pa;
            l2.mb[y] = pb;
          }
        }
      }

      // ---- C: L1 fill, displacing the L1 victim
      const bool ins = live && !hit1 && (PROMOTE || !l2_hit);
      if (ins || (TTL && DEMOTE)) {
        const int vw = victim<P>(r1, l1.ways, lane, t_put);
        const int32_t dk = bcast(r1.k, vw);
        const int32_t df = bcast(r1.f, vw);
        const int32_t dv = bcast(r1.v, vw);
        const int32_t da = bcast(r1.a, vw);
        const int32_t db = bcast(r1.b, vw);
        const int32_t de = bcast(r1.e, vw);
        const bool dvalid = ins && dk != rk::kEmpty;
        if (ins && lane == (vw & 31)) {
          const int64_t y = r1.base + vw;
          l1.keys[y] = q;
          l1.fpr[y] = fp;
          l1.vals[y] = l2_hit ? pval : q;
          l1.ma[y] = l2_hit ? pa : insert_a<P>(t_put);
          l1.mb[y] = l2_hit ? pb : insert_b<P>(t_put);
          if (l1.exp) l1.exp[y] = l2_hit ? pexp : dl;
        }

        // ---- D: demote the displaced entry into its own L2 set
        if (DEMOTE) {
          if (TTL || dvalid) {
            const int64_t s2v = rk::hash_u32((uint32_t)dk, seed2) & l2_mask;
            Row r3;
            load_row(l2, s2v, lane, r3);
            if (TTL) scrub(l2, r3, lane, horizon);
            if (dvalid) {
              const int vw2 = victim<P>(r3, l2.ways, lane, t_put);
              evs += bcast(r3.k, vw2) != rk::kEmpty;
              if (lane == (vw2 & 31)) {
                const int64_t y = r3.base + vw2;
                l2.keys[y] = dk;
                l2.fpr[y] = df;
                l2.vals[y] = dv;
                l2.ma[y] = da;
                l2.mb[y] = db;
                if (l2.exp) l2.exp[y] = de;
              }
            }
          }
        } else {
          evs += dvalid;
        }
      }
      hits += live && (hit1 || l2_hit);
    }
    if (lane == 0) {
      hits_out[t] = hits;
      evs_out[t] = evs;
    }
  }
}

template <int P, bool TTL>
int launch_moves(bool promote, bool demote, const Tier& l1, const Tier& l2,
                 const int32_t* clock0, const int32_t* qk, const uint8_t* en,
                 const int32_t* ttl, int T, int B, int l1_sets, int l2_sets,
                 uint32_t seed1, uint32_t seed2, int32_t* hits, int32_t* evs,
                 cudaStream_t s) {
#define RK_HIER(PR, DE)                                                  \
  hier_kernel<P, TTL, PR, DE><<<1, 32, 0, s>>>(                          \
      l1, l2, clock0, qk, en, ttl, T, B, l1_sets, l2_sets, seed1, seed2, \
      hits, evs)
  if (promote && demote) {
    RK_HIER(true, true);
  } else if (promote) {
    RK_HIER(true, false);
  } else if (demote) {
    RK_HIER(false, true);
  } else {
    RK_HIER(false, false);
  }
#undef RK_HIER
  return 0;
}

template <bool TTL>
int dispatch_policy(int policy, bool promote, bool demote, const Tier& l1,
                    const Tier& l2, const int32_t* clock0, const int32_t* qk,
                    const uint8_t* en, const int32_t* ttl, int T, int B,
                    int l1_sets, int l2_sets, uint32_t seed1, uint32_t seed2,
                    int32_t* hits, int32_t* evs, cudaStream_t s) {
#define RK_POLICY(P)                                                     \
  return launch_moves<P, TTL>(promote, demote, l1, l2, clock0, qk, en,  \
                              ttl, T, B, l1_sets, l2_sets, seed1, seed2, \
                              hits, evs, s)
  switch (policy) {
    case rk::LRU: RK_POLICY(rk::LRU);
    case rk::LFU: RK_POLICY(rk::LFU);
    case rk::FIFO: RK_POLICY(rk::FIFO);
    case rk::RANDOM: RK_POLICY(rk::RANDOM);
    case rk::HYPERBOLIC: RK_POLICY(rk::HYPERBOLIC);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RK_POLICY
}

}  // namespace

// Tiers: five int32 lanes each ([l1_sets, l1_ways] and [l2_sets, l2_ways])
// plus an expiry lane, null on both tiers or on neither (`ttl` non-null
// needs it).  Streams qk (sanitized keys) int32 [T*B], en uint8 [T*B], ttl
// int32 [T*B] or null.  Set counts are powers of two; seed1 (the salted L1
// seed) and seed2 hash keys to L1 and L2 sets.  hits, evs int32 [T].
extern "C" int replay_hier_launch(
    void* k1, void* f1, void* v1, void* a1, void* b1, void* e1, void* k2,
    void* f2, void* v2, void* a2, void* b2, void* e2, const void* clock0,
    const void* qk, const void* en, const void* ttl, int T, int B,
    int l1_sets, int l1_ways, int l2_sets, int l2_ways, int seed1, int seed2,
    int policy, int promote, int demote, void* hits, void* evs,
    void* stream) {
  if (T <= 0) return 0;
  if (B < 1 || l1_ways < 1 || l1_ways > rk::kMaxWays || l2_ways < 1 ||
      l2_ways > rk::kMaxWays || l1_sets < 1 || (l1_sets & (l1_sets - 1)) ||
      l2_sets < 1 || (l2_sets & (l2_sets - 1)) ||
      (e1 == nullptr) != (e2 == nullptr) ||
      (ttl != nullptr && e1 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Tier l1{(int32_t*)k1, (int32_t*)f1, (int32_t*)v1, (int32_t*)a1,
                (int32_t*)b1, (int32_t*)e1, l1_ways};
  const Tier l2{(int32_t*)k2, (int32_t*)f2, (int32_t*)v2, (int32_t*)a2,
                (int32_t*)b2, (int32_t*)e2, l2_ways};
  auto c = (const int32_t*)clock0;
  auto q = (const int32_t*)qk;
  auto e = (const uint8_t*)en;
  auto tt = (const int32_t*)ttl;
  auto h = (int32_t*)hits;
  auto ev = (int32_t*)evs;
  auto s = (cudaStream_t)stream;
  const int rc =
      tt != nullptr
          ? dispatch_policy<true>(policy, promote != 0, demote != 0, l1, l2,
                                  c, q, e, tt, T, B, l1_sets, l2_sets,
                                  (uint32_t)seed1, (uint32_t)seed2, h, ev, s)
          : dispatch_policy<false>(policy, promote != 0, demote != 0, l1, l2,
                                   c, q, e, tt, T, B, l1_sets, l2_sets,
                                   (uint32_t)seed1, (uint32_t)seed2, h, ev,
                                   s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
