// Hopper kernel 4 of the port: replay through the exclusive L1-over-L2
// hierarchy in ONE launch.
//
// Replaces the Pallas TPU kernel repro/kernels/replay.py:
// replay_hierarchical / _hier_replay_kernel (:652, :916).  The TPU kernel
// pinned a packed L1 in VMEM and DMA'd one packed L2 row at a time, with a
// scalar mailbox inside each row (a device against XLA's copy elision).
// None of that layout is carried over: both tiers are ordinary [S, ways]
// int32 lanes (+ the optional expiry lane) and scalars travel in registers.
//
// The semantics are sequential per lane (lane i sees lane i-1's moves;
// core/hierarchy.py), so ONE warp walks the T*B lanes in order, and the
// design takes as many memory round trips off that chain as the semantics
// allow:
//   * L1 in shared memory for the whole launch (the "shared" form): the
//     block loads the L1 lanes at the start and writes them back at the
//     end.  At 512 x 16 with the expiry lane that is 192 KiB, under the
//     227 KiB opt-in.  An L1 that does not fit (the wrapper decides by
//     size, kernels/replay.py hier_l1_form) stays in HBM (the "global"
//     form): the same code, reading the L1 through generic pointers.
//   * ways per thread as a template (NJ = 1, 2 or 4 for rows of up to 32,
//     64 or 128 ways): thread `l` of the warp owns ways l, l+32, .. of
//     every row of either tier, and every element of a tier is only ever
//     read and written by its owner thread, so program order alone orders
//     the accesses; at 16 and 8 ways each thread holds one slot.
//   * streams ahead: the warp loads 32 lanes' key, enable flag and TTL in
//     one coalesced load and hashes them (L1 set s1, L2 set s2,
//     fingerprint) in parallel; each lane's values are handed out by
//     __shfl_sync.  Keys never depend on the state.
//   * L2 rows ahead: the L2 row s2 of lane x + kAhead is copied by
//     cp.async into slot (x + kAhead) % kRing of a shared-memory ring
//     while lane x runs (each thread copies its own ways, 4 bytes each).
//     THE RULE for the rows lanes write meanwhile: every lane records the
//     L2 sets it stored to (a scrub that cleared a way, a promote clear or
//     in-place update, a demotion insert; at most two sets) in a history
//     of the last kRing lanes, one entry per thread.  Lane x takes its
//     prefetched row only if no lane in [x - kRing, x) stored to its set
//     (one __any_sync); otherwise it reloads the row from HBM with plain
//     loads, which see the owner thread's earlier stores.  The window
//     covers every store issued after the copy (issued kAhead = kRing - 1
//     lanes earlier) and one lane more before it.
//   * the demotion row early: the L1 victim of a miss is known right after
//     the L1 probe, so the loads of its key's L2 row start then and overlap
//     phase B.  If that row is s2 itself, phase B's row in registers (with
//     its stores applied) is used instead.
// Per lane:
//   A. probe the L1 row s1 (scrubbed at the chunk-exit horizon with TTLs):
//      a __ballot_sync of the key match gives the lowest matching way; an
//      enabled hit applies on_hit;
//   B. probe the L2 row s2 the same way (l2_hit = ~hit1 & hit2); the hit
//      entry's value, metadata and deadline are broadcast with __shfl_sync;
//      an enabled L2 hit clears the slot (promote) or updates it in place;
//   C. an enabled full miss (or a promotion) takes the L1 row's victim at
//      t_put: the least score by __reduce_min_sync on an order-preserving
//      u32 image of the float, ties to the lowest way; the displaced entry
//      is broadcast and the insert written by its owner;
//   D. with demote, the displaced entry goes to the victim of ITS OWN L2
//      set.  With TTLs, phase D's row is fetched and scrubbed even when
//      nothing is demoted, as the reference does.
// An eviction counts when an entry leaves both tiers.  There is no final
// full scrub: the hierarchy's scrub is lazy only.
//
// Bound: bytes (the key and enable streams, the lanes the policy reads of
// every L1 and L2 row the run touches, and the rows it writes), but the
// chain limits this design: one warp on 1 of 132 SMs runs every request's
// dependent instructions in turn.  Measured on an H100: the global form
// (the L1 row back on the chain) is only 3 % slower, and loading the
// demotion row a lane earlier made it slower, so memory latency no longer
// sets the pace.  The state is written inside the launch, so it is never
// read through __ldg or a const __restrict__ pointer.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 256;     // threads for the L1 load and write-back
constexpr int kRing = 8;        // ring slots = history entries / 2
constexpr int kAhead = kRing - 1;
constexpr int kLanes = 6;       // keys, fpr, vals, meta_a, meta_b, expiry

struct Tier {
  int32_t *keys, *fpr, *vals, *ma, *mb, *exp;  // exp null: no expiry lane
  int ways;
};

// One set row in registers: way w = lane + 32*j lives in slot j of thread
// `lane`; slots past `ways` hold EMPTY and never match or win.
template <int NJ>
struct Row {
  int32_t k[NJ], f[NJ], v[NJ], a[NJ], b[NJ], e[NJ];
  int64_t base;  // flat index of way 0
};

template <int NJ>
__device__ __forceinline__ void empty_slot(Row<NJ>& r, int j) {
  r.k[j] = rk::kEmpty;
  r.f[j] = r.v[j] = r.a[j] = r.b[j] = 0;
  r.e[j] = rk::kNoExpiry;
}

template <int NJ>
__device__ __forceinline__ void load_row(const Tier& tr, int64_t set,
                                         int lane, Row<NJ>& r) {
  r.base = set * tr.ways;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
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
      empty_slot(r, j);
    }
  }
}

// A ring slot: [kLanes][32 * NJ] int32, way w at column w.
template <int NJ>
__device__ __forceinline__ void prefetch_row(const Tier& tr, int64_t set,
                                             int lane, int32_t* slot) {
  const int64_t base = set * tr.ways;
  const int32_t* src[kLanes] = {tr.keys, tr.fpr, tr.vals,
                                tr.ma,   tr.mb,  tr.exp};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    if (w < tr.ways) {
#pragma unroll
      for (int f = 0; f < kLanes; ++f) {
        if (src[f] == nullptr) continue;
        const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
            slot + f * 32 * NJ + w);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(src[f] + base + w)
                     : "memory");
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void slot_row(const Tier& tr, int64_t set,
                                         int lane, const int32_t* slot,
                                         Row<NJ>& r) {
  r.base = set * tr.ways;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    if (w < tr.ways) {
      r.k[j] = slot[0 * 32 * NJ + w];
      r.f[j] = slot[1 * 32 * NJ + w];
      r.v[j] = slot[2 * 32 * NJ + w];
      r.a[j] = slot[3 * 32 * NJ + w];
      r.b[j] = slot[4 * 32 * NJ + w];
      r.e[j] = tr.exp ? slot[5 * 32 * NJ + w] : rk::kNoExpiry;
    } else {
      empty_slot(r, j);
    }
  }
}

// Store way w = lane + 32*j of the row (owner thread only).
template <int NJ>
__device__ __forceinline__ void store_way(const Tier& tr, const Row<NJ>& r,
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
// -> whether any way of the row was cleared (warp-uniform).
template <int NJ>
__device__ __forceinline__ bool scrub(const Tier& tr, Row<NJ>& r, int lane,
                                      int32_t horizon) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (lane + 32 * j < tr.ways && r.k[j] != rk::kEmpty &&
        r.e[j] <= horizon) {
      empty_slot(r, j);
      store_way(tr, r, lane, j);
      any = true;
    }
  }
  return __any_sync(kFull, any);
}

// Lowest way holding `qk` (fingerprint pre-filter, full-key confirm), or -1.
template <int NJ>
__device__ __forceinline__ int probe(const Row<NJ>& r, int32_t qk,
                                     int32_t fp) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bool m = r.k[j] != rk::kEmpty && r.f[j] == fp && r.k[j] == qk;
    const unsigned ballot = __ballot_sync(kFull, m);
    if (ballot) return 32 * j + __ffs(ballot) - 1;
  }
  return -1;
}

// Order-preserving image of a float score (-0 counts as +0, as the
// reference's comparisons do).
__device__ __forceinline__ unsigned ordered(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Policy victim at `now`: the lowest way of the least score (empty ways
// score kNegInf), by two warp min-reductions.
template <int P, int NJ>
__device__ __forceinline__ int victim(const Row<NJ>& r, int ways, int lane,
                                      int32_t now) {
  unsigned best = 0xFFFFFFFFu;
  int bw = 0xFFFF;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    if (w < ways) {
      const float s = r.k[j] == rk::kEmpty
                          ? rk::kNegInf
                          : rk::score<P>(r.k[j], r.a[j], r.b[j], now);
      const unsigned o = ordered(s);
      if (o < best || bw == 0xFFFF) {  // slots ascend: ties keep the lower
        best = o;
        bw = w;
      }
    }
  }
  const unsigned least = __reduce_min_sync(kFull, best);
  return (int)__reduce_min_sync(kFull,
                                best == least ? (unsigned)bw : 0xFFFFu);
}

// The value of way w in lane array `arr`, broadcast from its owner.
template <int NJ>
__device__ __forceinline__ int32_t bcast(const int32_t (&arr)[NJ], int w) {
  int32_t x = arr[0];
#pragma unroll
  for (int j = 1; j < NJ; ++j) {
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

// The streams of 32 consecutive lanes, one per thread: sanitized key, its
// fingerprint, L1 and L2 sets, enable flag, TTL.
struct Ahead {
  int32_t q, fp, s1, s2, tt;
  bool live;
};

__device__ __forceinline__ Ahead stream_ahead(
    const int32_t* qk, const uint8_t* en, const int32_t* ttl, int64_t x,
    int64_t n, uint32_t seed1, uint32_t seed2, uint32_t l1_mask,
    uint32_t l2_mask) {
  Ahead a{0, 0, 0, 0, 0, false};
  if (x < n) {
    a.q = qk[x];
    a.live = en[x] != 0;
    a.tt = ttl ? ttl[x] : 0;
  }
  a.fp = rk::fingerprint(a.q);
  a.s1 = (int32_t)(rk::hash_u32((uint32_t)a.q, seed1) & l1_mask);
  a.s2 = (int32_t)(rk::hash_u32((uint32_t)a.q, seed2) & l2_mask);
  return a;
}

// Dynamic shared memory: the ring [kRing][kLanes][32 * NJ] int32, then in
// the shared form the L1 lanes [6][l1_sets * l1_ways] int32.
template <int P, bool TTL, int NJ>
__global__ void __launch_bounds__(kBlock, 1)
    hier_kernel(Tier l1g, Tier l2, const int32_t* clock0, const int32_t* qk,
                const uint8_t* en, const int32_t* ttl, int T, int B,
                int l1_sets, int l2_sets, uint32_t seed1, uint32_t seed2,
                bool promote, bool demote, bool l1_shared, int32_t* hits_out,
                int32_t* evs_out) {
  extern __shared__ int32_t smem[];
  int32_t* ring = smem;
  Tier l1 = l1g;
  const int64_t l1_n = (int64_t)l1_sets * l1g.ways;
  if (l1_shared) {
    int32_t* next = ring + kRing * kLanes * 32 * NJ;
    auto stage = [&](int32_t* g) -> int32_t* {
      if (g == nullptr) return nullptr;
      int32_t* d = next;
      next += l1_n;
      for (int64_t i = threadIdx.x; i < l1_n; i += blockDim.x) d[i] = g[i];
      return d;
    };
    l1.keys = stage(l1g.keys);
    l1.fpr = stage(l1g.fpr);
    l1.vals = stage(l1g.vals);
    l1.ma = stage(l1g.ma);
    l1.mb = stage(l1g.mb);
    l1.exp = stage(l1g.exp);
    __syncthreads();
  }

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint32_t c0 = (uint32_t)clock0[0];
    const uint32_t b2 = 2u * (uint32_t)B;
    const uint32_t l1_mask = (uint32_t)l1_sets - 1u;
    const uint32_t l2_mask = (uint32_t)l2_sets - 1u;
    const int64_t n = (int64_t)T * B;
    const int slot_ints = kLanes * 32 * NJ;

    Ahead cur = stream_ahead(qk, en, ttl, lane, n, seed1, seed2, l1_mask,
                             l2_mask);
    Ahead nxt = stream_ahead(qk, en, ttl, 32 + lane, n, seed1, seed2,
                             l1_mask, l2_mask);
    // the L2 sets lanes stored to: entry 2*(x % kRing) (+1) of lane x
    int32_t hist = -1;
    // prime the ring with lanes 0 .. kAhead-1, one cp.async group each
    for (int m = 0; m < kAhead; ++m) {
      if (m < n) {
        const int32_t s = __shfl_sync(kFull, m < 32 ? cur.s2 : nxt.s2,
                                      m & 31);
        prefetch_row<NJ>(l2, s, lane, ring + (m % kRing) * slot_ints);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    int t = 0, i = 0, hits = 0, evs = 0;
    uint32_t base = c0;
    for (int64_t x = 0; x < n; ++x) {
      const int g = (int)(x & 31);
      // ---- the ring: copy lane x + kAhead's row, take lane x's
      {
        const int64_t m = x + kAhead;
        if (m < n) {
          const int mg = (int)(m & 31);
          const int32_t s =
              __shfl_sync(kFull, mg >= g ? cur.s2 : nxt.s2, mg);
          prefetch_row<NJ>(l2, s, lane, ring + (m % kRing) * slot_ints);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
      }
      const int32_t q = __shfl_sync(kFull, cur.q, g);
      const int32_t fp = __shfl_sync(kFull, cur.fp, g);
      const int32_t s1 = __shfl_sync(kFull, cur.s1, g);
      const int32_t s2 = __shfl_sync(kFull, cur.s2, g);
      const bool live = __shfl_sync(kFull, (int)cur.live, g) != 0;
      const int32_t horizon = (int32_t)(base + b2);
      const int32_t t_get = (int32_t)(base + (uint32_t)i);
      const int32_t t_put = (int32_t)(base + (uint32_t)B + (uint32_t)i);
      int32_t dl = rk::kNoExpiry;
      if (TTL) {
        const int32_t tt = __shfl_sync(kFull, cur.tt, g);
        if (tt > 0) dl = (int32_t)((uint32_t)horizon + (uint32_t)tt);
      }

      Row<NJ> r1, r2;
      load_row<NJ>(l1, s1, lane, r1);
      if (__any_sync(kFull, lane < 2 * kRing && hist == s2)) {
        load_row<NJ>(l2, s2, lane, r2);  // a recent lane stored to s2
      } else {
        slot_row<NJ>(l2, s2, lane, ring + (x % kRing) * slot_ints, r2);
      }
      bool wrote2 = false, wrote3 = false;
      if (TTL) {
        scrub<NJ>(l1, r1, lane, horizon);
        wrote2 = scrub<NJ>(l2, r2, lane, horizon);
      }

      // ---- A: L1 hit
      const int w1 = probe<NJ>(r1, q, fp);
      const bool hit1 = w1 >= 0;
      if (hit1 && live && P != rk::FIFO && P != rk::RANDOM &&
          lane == (w1 & 31)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j == (w1 >> 5)) {
            r1.a[j] = hit_a<P>(r1.a[j], t_get);
            l1.ma[r1.base + w1] = r1.a[j];
          }
        }
      }

      // ---- the L1 victim (phase C's), and phase D's row loads started
      // before phase B
      int vw = 0;
      int32_t dk = rk::kEmpty;
      int32_t s2v = -1;
      Row<NJ> r3;
      if (!hit1 || (TTL && demote)) {
        vw = victim<P, NJ>(r1, l1.ways, lane, t_put);
        dk = bcast<NJ>(r1.k, vw);
        if (demote && (TTL || (live && dk != rk::kEmpty))) {
          s2v = (int32_t)(rk::hash_u32((uint32_t)dk, seed2) & l2_mask);
          if (s2v != s2) load_row<NJ>(l2, s2v, lane, r3);
        }
      }

      // ---- B: L2 hit, promoted or updated in place
      const int w2 = probe<NJ>(r2, q, fp);
      const bool l2_hit = !hit1 && w2 >= 0;
      int32_t pval = 0, pa = 0, pb = 0, pexp = rk::kNoExpiry;
      if (l2_hit) {
        pval = bcast<NJ>(r2.v, w2);
        pa = hit_a<P>(bcast<NJ>(r2.a, w2), t_get);
        pb = bcast<NJ>(r2.b, w2);
        pexp = bcast<NJ>(r2.e, w2);
        if (live) {
          wrote2 = true;
          if (lane == (w2 & 31)) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if (j == (w2 >> 5)) {
                if (promote) {
                  empty_slot(r2, j);
                } else {
                  r2.a[j] = pa;
                  r2.b[j] = pb;
                }
                store_way<NJ>(l2, r2, lane, j);
              }
            }
          }
        }
      }

      // ---- C: L1 fill, displacing the L1 victim
      const bool ins = live && !hit1 && (promote || !l2_hit);
      if (ins || (TTL && demote)) {
        const int32_t df = bcast<NJ>(r1.f, vw);
        const int32_t dv = bcast<NJ>(r1.v, vw);
        const int32_t da = bcast<NJ>(r1.a, vw);
        const int32_t db = bcast<NJ>(r1.b, vw);
        const int32_t de = bcast<NJ>(r1.e, vw);
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
        if (demote) {
          if (TTL || dvalid) {
            if (s2v == s2) r3 = r2;  // phase B's row, its stores applied
            if (TTL) wrote3 = scrub<NJ>(l2, r3, lane, horizon);
            if (dvalid) {
              const int vw2 = victim<P, NJ>(r3, l2.ways, lane, t_put);
              evs += bcast<NJ>(r3.k, vw2) != rk::kEmpty;
              wrote3 = true;
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

      const int h = 2 * (int)(x % kRing);
      if (lane == h) hist = wrote2 ? s2 : -1;
      if (lane == h + 1) hist = wrote3 ? s2v : -1;

      if (++i == B) {
        if (lane == 0) {
          hits_out[t] = hits;
          evs_out[t] = evs;
        }
        hits = evs = 0;
        i = 0;
        ++t;
        base += b2;
      }
      if (g == 31) {
        cur = nxt;
        nxt = stream_ahead(qk, en, ttl, x + 33 + lane, n, seed1, seed2,
                           l1_mask, l2_mask);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  if (l1_shared) {
    __syncthreads();
    auto unstage = [&](int32_t* g, const int32_t* d) {
      if (g == nullptr) return;
      for (int64_t i = threadIdx.x; i < l1_n; i += blockDim.x) g[i] = d[i];
    };
    unstage(l1g.keys, l1.keys);
    unstage(l1g.fpr, l1.fpr);
    unstage(l1g.vals, l1.vals);
    unstage(l1g.ma, l1.ma);
    unstage(l1g.mb, l1.mb);
    unstage(l1g.exp, l1.exp);
  }
}

template <int NJ>
size_t ring_bytes() {
  return sizeof(int32_t) * kRing * kLanes * 32 * NJ;
}

template <int P, bool TTL, int NJ>
int launch_nj(const Tier& l1, const Tier& l2, bool l1_shared,
              const int32_t* clock0, const int32_t* qk, const uint8_t* en,
              const int32_t* ttl, int T, int B, int l1_sets, int l2_sets,
              uint32_t seed1, uint32_t seed2, bool promote, bool demote,
              int32_t* hits, int32_t* evs, cudaStream_t s) {
  const int lanes = l1.exp ? kLanes : kLanes - 1;
  const size_t smem =
      ring_bytes<NJ>() +
      (l1_shared ? sizeof(int32_t) * lanes * (size_t)l1_sets * l1.ways : 0);
  auto kernel = hier_kernel<P, TTL, NJ>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, kBlock, smem, s>>>(l1, l2, clock0, qk, en, ttl, T, B, l1_sets,
                                 l2_sets, seed1, seed2, promote, demote,
                                 l1_shared, hits, evs);
  return 0;
}

template <int P, bool TTL>
int launch_ways(int nj, const Tier& l1, const Tier& l2, bool l1_shared,
                const int32_t* clock0, const int32_t* qk, const uint8_t* en,
                const int32_t* ttl, int T, int B, int l1_sets, int l2_sets,
                uint32_t seed1, uint32_t seed2, bool promote, bool demote,
                int32_t* hits, int32_t* evs, cudaStream_t s) {
#define RK_NJ(N)                                                             \
  return launch_nj<P, TTL, N>(l1, l2, l1_shared, clock0, qk, en, ttl, T, B, \
                              l1_sets, l2_sets, seed1, seed2, promote,       \
                              demote, hits, evs, s)
  if (nj == 1) RK_NJ(1);
  if (nj == 2) RK_NJ(2);
  RK_NJ(4);
#undef RK_NJ
}

template <bool TTL>
int dispatch_policy(int policy, int nj, const Tier& l1, const Tier& l2,
                    bool l1_shared, const int32_t* clock0, const int32_t* qk,
                    const uint8_t* en, const int32_t* ttl, int T, int B,
                    int l1_sets, int l2_sets, uint32_t seed1, uint32_t seed2,
                    bool promote, bool demote, int32_t* hits, int32_t* evs,
                    cudaStream_t s) {
#define RK_POLICY(P)                                                         \
  return launch_ways<P, TTL>(nj, l1, l2, l1_shared, clock0, qk, en, ttl, T, \
                             B, l1_sets, l2_sets, seed1, seed2, promote,     \
                             demote, hits, evs, s)
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
// seed) and seed2 hash keys to L1 and L2 sets.  l1_shared: keep the L1 in
// shared memory for the launch (the caller checks that it fits).  hits,
// evs int32 [T].
extern "C" int replay_hier_launch(
    void* k1, void* f1, void* v1, void* a1, void* b1, void* e1, void* k2,
    void* f2, void* v2, void* a2, void* b2, void* e2, const void* clock0,
    const void* qk, const void* en, const void* ttl, int T, int B,
    int l1_sets, int l1_ways, int l2_sets, int l2_ways, int seed1, int seed2,
    int policy, int promote, int demote, int l1_shared, void* hits,
    void* evs, void* stream) {
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
  const int widest = l1_ways > l2_ways ? l1_ways : l2_ways;
  const int nj = widest <= 32 ? 1 : widest <= 64 ? 2 : 4;
  auto c = (const int32_t*)clock0;
  auto q = (const int32_t*)qk;
  auto e = (const uint8_t*)en;
  auto tt = (const int32_t*)ttl;
  auto h = (int32_t*)hits;
  auto ev = (int32_t*)evs;
  auto s = (cudaStream_t)stream;
  const int rc =
      tt != nullptr
          ? dispatch_policy<true>(policy, nj, l1, l2, l1_shared != 0, c, q, e,
                                  tt, T, B, l1_sets, l2_sets, (uint32_t)seed1,
                                  (uint32_t)seed2, promote != 0, demote != 0,
                                  h, ev, s)
          : dispatch_policy<false>(policy, nj, l1, l2, l1_shared != 0, c, q,
                                   e, tt, T, B, l1_sets, l2_sets,
                                   (uint32_t)seed1, (uint32_t)seed2,
                                   promote != 0, demote != 0, h, ev, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
