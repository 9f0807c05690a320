// Hopper kernel 3 of the port: a whole chunked trace replayed through the
// k-way cache, set-partitioned over the whole card.
//
// Replaces the Pallas TPU kernel repro/kernels/replay.py: replay_resident /
// _replay_kernel (:83, :549), its flat, TTL and TinyLFU branches.
//
// The TPU kernel walked the chunks as a sequential grid with the state
// pinned in VMEM.  Here the state lives in HBM (24 MiB at 2^20 entries with
// the expiry lane, so it stays in the 50 MB L2) and is updated in place.
//
// THE PREMISE: the chunked semantics split exactly by set.  A key maps to
// one set, so dedupe only compares lanes of one set; the same-set rank, the
// victim order and the last-writer rule are per set; lane i of chunk t runs
// at base+i / base+B+i whatever the other lanes do; the TTL scrub is per
// row.  Only TinyLFU's sketch is shared across sets.  So an OWNER, a range
// of 2^shift consecutive sets (owner = set >> shift; the wrapper picks shift
// so that there are at most 8192 owners), replays its lanes alone:
//
//   bucketing (bucket_count, bucket_offsets, bucket_scatter): a stable
//     counting sort of the enabled lanes by owner.  Segments of `seg`
//     lanes count their owners in shared memory; one pass scans the
//     (segment, owner) counts owner-major; then one warp per segment walks
//     its lanes in order and scatters each lane's flat index t*B+i, key and
//     set to its owner's bucket (rank in the warp by __match_any_sync), so
//     every bucket keeps (t, i) order, and records each lane's position.
//     Disabled lanes are dropped: they touch nothing.  Also counts the
//     enabled lanes of each chunk.
//
//   the "owners" form (flat and TTL): one warp per owner walks its bucket
//     once, one GROUP (its lanes of one chunk t) at a time, in sub-batches
//     of 32 lanes (the hot set of the full-size zipf trace puts about 24
//     lanes in a group), with no grid synchronisation:
//       0. with an expiry lane, scrub the rows the group touches at the
//          chunk-exit horizon base+2B (lazy scrub: an untouched row is read
//          by nobody, and each owner scrubs its sets at the final horizon
//          at the end, so counts and state equal the reference's eager
//          scrub of the whole state every chunk);
//       A. probe on the pre-hit state; a hit applies on_hit to meta_a by
//          atomicMax (LRU) or atomicAdd (LFU/HYPERBOLIC), which commute, and
//          a probe never reads meta_a, so one pass also finds the eligible
//          lanes (missing, enabled, admitted).  Dedupe and rank per set:
//          within a sub-batch by __match_any_sync on the key and on the
//          set, across sub-batches against the group's list of inserting
//          lanes (a set's count of first occurrences; a key is compared
//          only while its set has taken fewer than `ways`).  The list keeps
//          the inserting lanes in batch order, in shared memory;
//       B. each inserting lane takes the rank-th worst victim of its own
//          order at base+B+i on the post-hit, pre-insert state (IEEE
//          scores, ties to the lowest way: common.cuh);
//       C. of the inserting lanes that chose one (set, way), only the last
//          in batch order writes: resolved in the list, so no global
//          `winner` array and no memset;
//       per-chunk hits and evictions go to hits[t] / evs[t] (zeroed first)
//       by integer atomicAdd, once per group.
//     No owner reads another owner's rows, so __syncwarp orders all.
//
//   the "grid" form (TinyLFU): a cooperative grid (co-resident blocks sized
//     by the occupancy API, grid.sync()) walks the chunks with two barriers
//     per chunk (grid_kernel):
//       record pass 1 over the chunk's lanes: read the PRE-chunk door bit
//         and counter words and park the 4 candidate words (pre + one
//         nibble; 0: no increment) in `rec`; elect the last enabled lane of
//         each door word by atomicMax of its flat index into `door_win`
//         (never reset: indices grow; the election needs only the chunk's
//         keys); list the chunk's groups (their first lanes) -> sync;
//       merge the counter words by atomicMax of whole uint32 words; the
//         elected lanes OR their bits into the pre-chunk words; every block
//         adds the chunk's enabled count (from the bucketing) to its own
//         copy of the additions tally, so the tally needs no atomics -> sync;
//         at `sample`: halve every counter (& 0x77777777) and clear the
//         door -> sync;
//       each listed group gets a warp: admit (peek on the pre-hit state at
//         base+i, estimate on the post-record sketch; the flags kept as
//         bits in shared memory), then A-C; meanwhile the next chunk's
//         record pass 1, which only reads the sketch, runs on other threads.
//     Sketch words, `rec` and the work lists written by other blocks are
//     read through L2 (__ldcg).
//
//   the "block" form (TinyLFU, narrow chunks, e.g. B = 1 in
//     simulate.replay): one thread block walks the chunks with
//     __syncthreads() between the same phases, every lane of a chunk
//     staged in shared memory; dedupe, rank and the last writer scan the
//     earlier (later) lanes of the chunk, which is cheap when B is small:
//     below about 16 lanes two grid barriers per chunk cost more.
//
// The wrapper (kernels/replay.py replay_form) picks the form by shape.  The
// state is written inside the launch, so it is never read through __ldg or a
// const __restrict__ pointer; the bucketed lanes are (they are read-only).
//
// Bound: bytes (the key and enable streams, the lanes the policy reads of
// every row the trace touches, the state written back, 8 B per chunk; with
// TinyLFU the sketch words touched).  What sets the pace (measured on an
// H100, PERF.md section 6): in the owners form the hottest owner's chain,
// about 1.7 us a group (two dependent L2 round trips and the warp's
// instructions) over the 4096 chunks of the full-size trace; in the grid
// form about 11.5 us a chunk (two grid barriers and one group's chain,
// admission included); in the bucketing its scattered 4-byte stores.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kOwnerWarps = 4;      // warps per block of the owners form
constexpr int kGridThreads = 1024;  // threads per block of the grid form

enum Form { OWNERS = 0, GRID = 1, BLOCK = 2 };

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// ---------------------------------------------------------------------------
// bucketing: a stable counting sort of the enabled lanes by owner
// ---------------------------------------------------------------------------

// Per segment g: the owner histogram -> cnt[g * owners + o], added into
// tot[o]; the enabled lanes of each chunk -> live[t].  tot and live zeroed.
__global__ void __launch_bounds__(256)
    bucket_count(const int32_t* sets, const uint8_t* en, int n, int B,
                 int seg, int owners, int shift, int32_t* cnt, int32_t* tot,
                 int32_t* live) {
  extern __shared__ int32_t hist[];
  for (int o = threadIdx.x; o < owners; o += blockDim.x) hist[o] = 0;
  __syncthreads();
  const int lo = blockIdx.x * seg;
  const int hi = min(n, lo + seg);
  const int lane = threadIdx.x & 31;
  for (int b = lo; b < hi; b += blockDim.x) {
    const int l = b + threadIdx.x;
    const bool on = l < hi && en[l] != 0;
    if (on) atomicAdd(&hist[sets[l] >> shift], 1);
    const unsigned m = __match_any_sync(kFull, on ? l / B : -1);
    if (on && (m & ((1u << lane) - 1u)) == 0) {  // lowest lane of its chunk
      atomicAdd(&live[l / B], __popc(m));
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < owners; o += blockDim.x) {
    cnt[(int64_t)blockIdx.x * owners + o] = hist[o];
    if (hist[o]) atomicAdd(&tot[o], hist[o]);
  }
}

// Every block scans the owner totals into shared memory; thread o of the
// grid then turns its owner's column of counts into bucket positions:
// cnt[g * owners + o] = start[o] + lanes of o in segments before g.
// Block 0 writes start[0..owners].
__global__ void __launch_bounds__(1024)
    bucket_offsets(int32_t* cnt, const int32_t* tot, int owners,
                   int segments, int32_t* start) {
  extern __shared__ int32_t s_start[];  // [owners + 1]
  __shared__ int32_t s_warp[32];
  const int per = (owners + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per; ++k) {
    if (lo + k < owners) sum += tot[lo + k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += v;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive prefix of warp totals
  }
  __syncthreads();
  int run = incl - sum + (warp ? s_warp[warp - 1] : 0);
  for (int k = 0; k < per; ++k) {
    if (lo + k < owners) {
      s_start[lo + k] = run;
      run += tot[lo + k];
    }
  }
  if (lo < owners && lo + per >= owners) s_start[owners] = run;
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int o = threadIdx.x; o <= owners; o += blockDim.x) {
      start[o] = s_start[o];
    }
  }
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= owners) return;
  int pos = s_start[o];
  constexpr int kAhead = 16;  // loads in flight down the column
  for (int g0 = 0; g0 < segments; g0 += kAhead) {
    int v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      v[k] = g0 + k < segments ? cnt[(int64_t)(g0 + k) * owners + o] : 0;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (g0 + k < segments) cnt[(int64_t)(g0 + k) * owners + o] = pos;
      pos += v[k];
    }
  }
}

// One warp per segment, in lane order: each enabled lane goes to its
// owner's next bucket position (stable).  The lowest lane of each owner in
// a step of 32 takes the owner's positions by a shared-memory atomicAdd,
// whose return orders the steps, and hands them out by __shfl_sync, so no
// __syncwarp waits for the scattered stores.  The lanes of the next kSteps
// steps are loaded while the current ones are placed.
__global__ void __launch_bounds__(32)
    bucket_scatter(const int32_t* qk, const int32_t* sets,
                               const uint8_t* en, int n, int seg, int owners,
                               int shift, const int32_t* cnt,
                               int32_t* lane_out, int32_t* key_out,
                               int32_t* set_out, int32_t* pos_out) {
  constexpr int kSteps = 4;
  extern __shared__ int32_t ctr[];  // [owners] next position of each owner
  const int lane = threadIdx.x;
#pragma unroll 8
  for (int o = lane; o < owners; o += 32) {
    ctr[o] = cnt[(int64_t)blockIdx.x * owners + o];
  }
  __syncwarp();
  const int lo = blockIdx.x * seg;
  const int hi = min(n, lo + seg);
  const unsigned lt = (1u << lane) - 1u;
  bool on[kSteps];
  int32_t s[kSteps], k[kSteps];
  auto fetch = [&](int b) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int l = b + 32 * j + lane;
      on[j] = l < hi && en[l] != 0;
      s[j] = l < hi ? sets[l] : 0;
      k[j] = l < hi ? qk[l] : 0;
    }
  };
  fetch(lo);
  for (int b = lo; b < hi; b += 32 * kSteps) {
    bool on_c[kSteps];
    int32_t s_c[kSteps], k_c[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      on_c[j] = on[j];
      s_c[j] = s[j];
      k_c[j] = k[j];
    }
    fetch(b + 32 * kSteps);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int l = b + 32 * j + lane;
      const int o = on_c[j] ? s_c[j] >> shift : -1;
      const unsigned m = __match_any_sync(kFull, o);
      const int leader = __ffs(m) - 1;
      int c = 0;
      if (on_c[j] && lane == leader) c = atomicAdd(&ctr[o], __popc(m));
      c = __shfl_sync(kFull, c, leader) + __popc(m & lt);
      if (on_c[j]) {
        lane_out[c] = l;
        key_out[c] = k_c[j];
        set_out[c] = s_c[j];
        pos_out[l] = c;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the replay
// ---------------------------------------------------------------------------

struct State {
  int32_t *keys, *fpr, *vals, *ma, *mb, *exp;
  int ways;
};

// The bucketed lanes: lane[p] = t*B+i, key[p], set[p] for p in
// [start[o], start[o+1]) of owner o.
struct Lanes {
  const int32_t* lane;
  const int32_t* key;
  const int32_t* set;
  const int32_t* start;
  int owners, shift;
};

// The TinyLFU sketch (core/admission.py): 4 rows of `w8` packed words of
// 4-bit counters, `door_words` doorkeeper words, the additions tally.
struct Sketch {
  uint32_t* pk;        // [4, w8]
  uint32_t* door;      // [door_words]
  int32_t* adds;       // [1]
  int32_t* door_win;   // [door_words] scratch, -1 at launch
  uint32_t* rec;       // [4, B] scratch: candidate words of a chunk
  int w8, door_words;
  uint32_t width_mask, door_mask;
  int sample;
};

__device__ __forceinline__ void scrub_row(const State& st, int64_t row,
                                          int32_t horizon) {
  for (int w = 0; w < st.ways; ++w) {
    const int64_t x = row + w;
    if (st.keys[x] != rk::kEmpty && st.exp[x] <= horizon) {
      st.keys[x] = rk::kEmpty;
      st.fpr[x] = 0;
      st.vals[x] = 0;
      st.ma[x] = 0;
      st.mb[x] = 0;
      st.exp[x] = rk::kNoExpiry;
    }
  }
}

__device__ __forceinline__ uint32_t door_hash(const Sketch& sk, uint32_t k) {
  return rk::hash_u32(k, 0xD00Eu) & sk.door_mask;
}

// (word index into pk, nibble shift) of key k in count-min row r
__device__ __forceinline__ void counter_pos(const Sketch& sk, uint32_t k,
                                            int r, int64_t* word,
                                            uint32_t* shift) {
  const uint32_t idx = rk::hash_u32(k, 0xA000u + r) & sk.width_mask;
  *word = (int64_t)r * sk.w8 + (idx >> 3);
  *shift = (idx & 7u) * 4u;
}

// admission.estimate: count-min minimum + the doorkeeper bit, read at L2
// (other blocks of the grid form write the sketch)
__device__ __forceinline__ int estimate(const Sketch& sk, uint32_t k) {
  int est = 15;
  for (int r = 0; r < 4; ++r) {
    int64_t word;
    uint32_t shift;
    counter_pos(sk, k, r, &word, &shift);
    est = min(est, (int)((__ldcg(sk.pk + word) >> shift) & 0xFu));
  }
  const uint32_t dh = door_hash(sk, k);
  return est + (int)((__ldcg(sk.door + (dh >> 5)) >> (dh & 31u)) & 1u);
}

// First way of the row holding `key` (the fingerprint pre-filters, the full
// key confirms), or -1.  Up to 16 ways every way's key and fingerprint are
// loaded at once, so a miss costs one round trip, not one per way.
template <int MAXW>
__device__ __forceinline__ int probe_ways(const State& st, int64_t row,
                                          int32_t key) {
  if constexpr (MAXW > 16) {
    return rk::probe_row(st.keys, st.fpr, row, st.ways, key);
  } else {
    const int32_t qfp = rk::fingerprint(key);
    int32_t k[MAXW], f[MAXW];
    rk::for_ways<MAXW>(st.ways, [&](int w) {
      k[w] = st.keys[row + w];
      f[w] = st.fpr[row + w];
    });
    int hit = -1;
    rk::for_ways<MAXW>(st.ways, [&](int w) {
      if (hit < 0 && k[w] != rk::kEmpty && f[w] == qfp && k[w] == key) {
        hit = w;
      }
    });
    return hit;
  }
}

// The lane-victim of admission: the worst way of the row at time `now`
// (the first of the stable ascending order of the scores).
template <int P, int MAXW>
__device__ __forceinline__ int worst_way(const State& st, int64_t row,
                                         int32_t now) {
  float sc[MAXW];
  rk::row_scores<P, MAXW>(st.keys, st.ma, st.mb, row, st.ways, now, sc);
  int vw = 0;
  float best = sc[0];
  rk::for_ways<MAXW>(st.ways, [&](int w) {
    if (sc[w] < best) {
      best = sc[w];
      vw = w;
    }
  });
  return vw;
}

// admit a missing lane: the victim slot is empty, or the candidate's
// estimate beats the victim's
template <int P, int MAXW>
__device__ __forceinline__ bool admits(const State& st, const Sketch& sk,
                                       int64_t row, int32_t key,
                                       int32_t now) {
  if (probe_ways<MAXW>(st, row, key) >= 0) return true;
  const int32_t vkey = st.keys[row + worst_way<P, MAXW>(st, row, now)];
  return vkey == rk::kEmpty ||
         estimate(sk, (uint32_t)key) > estimate(sk, (uint32_t)vkey);
}

template <int P>
__device__ __forceinline__ void write_insert(const State& st, int64_t x,
                                             int32_t key, int32_t t_put) {
  st.keys[x] = key;
  st.fpr[x] = rk::fingerprint(key);
  st.vals[x] = key;  // replay payload convention: val == key
  if (P == rk::LRU || P == rk::FIFO) {
    st.ma[x] = t_put;
    st.mb[x] = 0;
  } else if (P == rk::RANDOM) {
    st.ma[x] = 0;
    st.mb[x] = 0;
  } else {  // LFU: (1, 0); HYPERBOLIC: (n=1, t0=now)
    st.ma[x] = 1;
    st.mb[x] = P == rk::HYPERBOLIC ? t_put : 0;
  }
}

// Per-warp shared scratch of a group (owners and grid forms).
struct Scratch {
  int32_t* n;      // [1 << shift] first occurrences per set of the owner
  int32_t* key;    // [cap] inserting lanes, in batch order: key
  int32_t* idx;    // [cap] lane index i in the chunk
  int32_t* slot;   // [cap] (set-local << 8) | rank, after B | way
  uint32_t* adm;   // [ceil(B/32)] admission bits of the group (TinyLFU)
};

__host__ __device__ __forceinline__ int scratch_ints(int nsl, int cap,
                                                     int admw) {
  return nsl + 3 * cap + admw;
}

__device__ __forceinline__ Scratch scratch_at(int32_t* smem, int warp,
                                              int nsl, int cap, int admw) {
  int32_t* p = smem + (int64_t)warp * scratch_ints(nsl, cap, admw);
  return Scratch{p, p + nsl, p + nsl + cap, p + nsl + 2 * cap,
                 (uint32_t*)(p + nsl + 3 * cap)};
}

// One bucketed lane as a thread of the warp holds it; l < 0: none.
struct Lane {
  int l;
  int32_t key, set;
};

__device__ __forceinline__ Lane load_lane(const Lanes& L, int p, int end) {
  Lane x{-1, 0, 0};
  if (p < end) {
    x.l = __ldg(L.lane + p);
    x.key = __ldg(L.key + p);
    x.set = __ldg(L.set + p);
  }
  return x;
}

// End of the group starting at `pos` (the owner's lanes of chunk t, a
// prefix of the window `w` = the lanes at pos + lane).
__device__ __forceinline__ int group_end(const Lanes& L, const Lane& w,
                                         int pos, int end, int t, int B,
                                         int lane) {
  unsigned m = __ballot_sync(kFull, w.l >= 0 && w.l / B == t);
  int gend = pos + __popc(m);
  while (m == kFull) {
    const int p = gend + lane;
    m = __ballot_sync(kFull, p < end && __ldg(L.lane + p) / B == t);
    gend += __popc(m);
  }
  return gend;
}

// One warp replays one group: the lanes [pos, gend) of an owner whose first
// set is set0, all of chunk t (clock origin `base`); w0 = the window at pos.
template <int P, bool TTL, bool TL, int MAXW>
__device__ void run_group(const State& st, const Lanes& L,
                          const Scratch& ws, const Sketch& sk,
                          const int32_t* ttl, int32_t* hits, int32_t* evs,
                          int set0, int pos, int gend, const Lane& w0, int t,
                          uint32_t base, int B, int lane) {
  const int ways = st.ways;
  const int nsl = 1 << L.shift;
  const int off = t * B;
  const unsigned lt = (1u << lane) - 1u;
  const uint32_t ub = (uint32_t)B;
  auto lane_at = [&](int sb) {
    if (sb != pos) return load_lane(L, sb + lane, gend);
    Lane x = w0;
    if (pos + lane >= gend) x.l = -1;
    return x;
  };

  if (TTL) {  // 0: lazy scrub of the rows the group touches
    const int32_t horizon = (int32_t)(base + 2u * ub);
    for (int sb = pos; sb < gend; sb += 32) {
      const Lane x = lane_at(sb);
      if (x.l >= 0) scrub_row(st, (int64_t)x.set * ways, horizon);
    }
    __syncwarp();
  }

  if (TL) {  // admission on the pre-hit state at base+i
    for (int sb = pos, k = 0; sb < gend; sb += 32, ++k) {
      const Lane x = lane_at(sb);
      const bool a = x.l < 0 || admits<P, MAXW>(
          st, sk, (int64_t)x.set * ways, x.key,
          (int32_t)(base + (uint32_t)(x.l - off)));
      const unsigned bits = __ballot_sync(kFull, a);
      if (lane == 0) ws.adm[k] = bits;
    }
  }

  // A: hits at base+i; eligibility; dedupe and rank per set
  for (int x = lane; x < nsl; x += 32) ws.n[x] = 0;
  __syncwarp();
  int count = 0;  // inserting lanes listed so far (warp-uniform)
  int my_hits = 0;
  for (int sb = pos, k = 0; sb < gend; sb += 32, ++k) {
    const Lane x = lane_at(sb);
    bool elig = false;
    int sl = -1;
    if (x.l >= 0) {
      const int64_t row = (int64_t)x.set * ways;
      const int hw = probe_ways<MAXW>(st, row, x.key);
      if (hw >= 0) {
        ++my_hits;
        if (P == rk::LRU) {
          atomicMax(&st.ma[row + hw], (int32_t)(base + (uint32_t)(x.l - off)));
        }
        if (P == rk::LFU || P == rk::HYPERBOLIC) atomicAdd(&st.ma[row + hw], 1);
      }
      elig = hw < 0 && (!TL || ((ws.adm[k] >> lane) & 1u));
      sl = x.set & (nsl - 1);
    }
    const unsigned em = __ballot_sync(kFull, elig);
    const unsigned same_key =
        __match_any_sync(kFull, elig ? x.key : rk::kEmpty) & em;
    bool first = elig && !(same_key & lt);
    int n0 = 0;
    if (first) {
      n0 = ws.n[sl];
      // an earlier sub-batch's lane of this key inserted, unless the set
      // was already full (then this lane cannot insert either)
      if (n0 < ways) {
        for (int j = 0; j < count; ++j) {
          if (ws.key[j] == x.key) {
            first = false;
            break;
          }
        }
      }
    }
    const unsigned fm = __ballot_sync(kFull, first);
    const unsigned same_set = __match_any_sync(kFull, first ? sl : -1) & fm;
    const int rank = n0 + __popc(same_set & lt);
    const bool ins = first && rank < ways;
    const unsigned im = __ballot_sync(kFull, ins);
    if (ins) {
      const int e = count + __popc(im & lt);
      ws.key[e] = x.key;
      ws.idx[e] = x.l - off;
      ws.slot[e] = (sl << 8) | rank;
    }
    count += __popc(im);
    __syncwarp();
    if (first && (same_set >> lane) == 1u) ws.n[sl] = rank + 1;
    __syncwarp();
  }
  my_hits = warp_sum(my_hits);
  if (lane == 0 && my_hits) atomicAdd(&hits[t], my_hits);

  // B: the rank-th worst victim at base+B+i, post-hit / pre-insert
  int my_evs = 0;
  for (int e = lane; e < count; e += 32) {
    const int sr = ws.slot[e];
    const int rank = sr & 0xFF;
    const int64_t row = (int64_t)(set0 + (sr >> 8)) * ways;
    float sc[MAXW];
    rk::row_scores<P, MAXW>(st.keys, st.ma, st.mb, row, ways,
                            (int32_t)(base + ub + (uint32_t)ws.idx[e]), sc);
    int vw = 0;
    rk::victim_order<MAXW>(sc, ways, [&](int p, int w) {
      if (p == rank) vw = w;
    });
    my_evs += st.keys[row + vw] != rk::kEmpty;
    ws.slot[e] = (sr & ~0xFF) | vw;
  }
  __syncwarp();

  // C: apply, the last inserting lane of each (set, way) only
  for (int e = lane; e < count; e += 32) {
    const int sw = ws.slot[e];
    bool last = true;
    for (int j = e + 1; j < count; ++j) {
      if (ws.slot[j] == sw) {
        last = false;
        break;
      }
    }
    if (!last) continue;
    const int64_t x = (int64_t)(set0 + (sw >> 8)) * ways + (sw & 0xFF);
    const int i = ws.idx[e];
    write_insert<P>(st, x, ws.key[e], (int32_t)(base + ub + (uint32_t)i));
    if (TTL) {
      const int32_t tt = ttl ? ttl[off + i] : 0;
      st.exp[x] = tt > 0 ? (int32_t)(base + 2u * ub + (uint32_t)tt)
                         : rk::kNoExpiry;
    }
  }
  my_evs = warp_sum(my_evs);
  if (lane == 0 && my_evs) atomicAdd(&evs[t], my_evs);
  __syncwarp();
}

// ---- the owners form: one warp per owner, no grid synchronisation
template <int P, bool TTL, int MAXW>
__global__ void __launch_bounds__(kOwnerWarps * 32)
    owners_kernel(State st, Lanes L, const int32_t* clock0,
                  const int32_t* ttl, int T, int B, int S, int cap,
                  int32_t* hits, int32_t* evs) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * kOwnerWarps + warp;
  if (o >= L.owners) return;
  const int nsl = 1 << L.shift;
  const Scratch ws = scratch_at(smem, warp, nsl, cap, 0);
  const uint32_t c0 = (uint32_t)clock0[0];
  const uint32_t b2 = 2u * (uint32_t)B;
  const int set0 = o << L.shift;
  const int end = __ldg(L.start + o + 1);
  int pos = __ldg(L.start + o);
  Lane w = load_lane(L, pos + lane, end);
  while (pos < end) {
    const int t = __shfl_sync(kFull, w.l, 0) / B;
    const int gend = group_end(L, w, pos, end, t, B, lane);
    const Lane next = load_lane(L, gend + lane, end);  // the next window
    run_group<P, TTL, false, MAXW>(st, L, ws, Sketch{}, ttl, hits, evs, set0,
                                   pos, gend, w, t, c0 + b2 * (uint32_t)t, B,
                                   lane);
    pos = gend;
    w = next;
  }
  if (TTL && T > 0) {  // the owner's sets at the final horizon
    const int32_t horizon = (int32_t)(c0 + b2 * (uint32_t)T);
    for (int s = set0 + lane; s < min(set0 + nsl, S); s += 32) {
      scrub_row(st, (int64_t)s * st.ways, horizon);
    }
  }
}

// ---- the grid form: TinyLFU over a cooperative grid
//
// Record pass 1 of chunk t: each enabled lane reads the PRE-chunk door bit
// and counter words and parks its 4 candidate words in `rec`, elects its
// door word's last lane (atomicMax into door_win: it depends on the chunk's
// keys only), and, if it is the first lane of its group (its owner's first
// bucketed lane of chunk t), appends the group to the chunk's work list.
__device__ __forceinline__ void record_pass1(const Sketch& sk,
                                             const Lanes& L,
                                             const int32_t* qk,
                                             const uint8_t* en,
                                             const int32_t* pos, int t, int B,
                                             int rid, int nthreads,
                                             int32_t* work, int32_t* work_n) {
  const int off = t * B;
  for (int i = rid; i < B; i += nthreads) {
    const int l = off + i;
    if (en[l] == 0) continue;
    const uint32_t k = (uint32_t)qk[l];
    const uint32_t dh = door_hash(sk, k);
    const bool in_door = (__ldcg(sk.door + (dh >> 5)) >> (dh & 31u)) & 1u;
    for (int r = 0; r < 4; ++r) {
      uint32_t nw = 0;
      if (in_door) {
        int64_t word;
        uint32_t shift;
        counter_pos(sk, k, r, &word, &shift);
        const uint32_t cur = __ldcg(sk.pk + word);
        if (((cur >> shift) & 0xFu) < 15u) nw = cur + (1u << shift);
      }
      sk.rec[(int64_t)r * B + i] = nw;
    }
    atomicMax(&sk.door_win[dh >> 5], l);
    const int p = pos[l];
    const int o = __ldg(L.set + p) >> L.shift;
    if (p == __ldg(L.start + o) || __ldg(L.lane + p - 1) / B != t) {
      work[(t & 1) * B + atomicAdd(&work_n[t & 1], 1)] = p;
    }
  }
}

// Per chunk, two grid barriers (three more on an aging chunk):
//   A: every record pass 1 of chunk t is done -> merge the counter words by
//      atomicMax of whole uint32 words; the elected lane ORs its bit into
//      the pre-chunk door word; the tally grows by the chunk's enabled
//      count (every block keeps its own copy: no atomics) -> B;
//   at `sample`: halve every counter (& 0x77777777), clear the door -> sync;
//   then each group of the chunk's work list gets its own warp: admit
//      (peek on the pre-hit state at base+i, estimate on the post-record
//      sketch), then A-C of run_group; and the threads of the grid's end run
//      record pass 1 of chunk t+1, which only reads the sketch.
// A group's rows may be run by another SM in a later chunk: the grid
// barriers order those accesses.
template <int P, int MAXW>
__global__ void __launch_bounds__(kGridThreads)
    grid_kernel(State st, Lanes L, Sketch sk, const int32_t* clock0,
                const int32_t* qk, const uint8_t* en, const int32_t* live,
                const int32_t* pos, int T, int B, int cap, int32_t* work,
                int32_t* work_n, int32_t* hits, int32_t* evs) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsl = 1 << L.shift;
  const Scratch ws = scratch_at(smem, warp, nsl, cap, (B + 31) / 32);
  const uint32_t c0 = (uint32_t)clock0[0];
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rid = nthreads - 1 - gtid;  // record passes from the grid's end
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  int adds = sk.adds[0];

  record_pass1(sk, L, qk, en, pos, 0, B, rid, nthreads, work, work_n);
  for (int t = 0; t < T; ++t) {
    const uint32_t base = c0 + 2u * (uint32_t)B * (uint32_t)t;
    const int off = t * B;
    grid.sync();  // A
    for (int i = rid; i < B; i += nthreads) {
      if (en[off + i] == 0) continue;
      const uint32_t k = (uint32_t)qk[off + i];
      for (int r = 0; r < 4; ++r) {
        const uint32_t nw = __ldcg(sk.rec + (int64_t)r * B + i);
        if (nw == 0) continue;
        int64_t word;
        uint32_t shift;
        counter_pos(sk, k, r, &word, &shift);
        atomicMax(&sk.pk[word], nw);
      }
      const uint32_t dh = door_hash(sk, k);
      if (__ldcg(sk.door_win + (dh >> 5)) == off + i) {
        atomicOr(&sk.door[dh >> 5], 1u << (dh & 31u));
      }
    }
    if (gtid == 0) work_n[(t + 1) & 1] = 0;  // its last readers passed A
    adds += live[t];
    grid.sync();  // B
    if (adds >= sk.sample) {  // aging: the same decision in every block
      for (int64_t x = gtid; x < 4 * (int64_t)sk.w8; x += nthreads) {
        sk.pk[x] = (__ldcg(sk.pk + x) >> 1) & 0x77777777u;
      }
      for (int x = gtid; x < sk.door_words; x += nthreads) sk.door[x] = 0;
      adds = 0;
      grid.sync();
    }
    const int nwork = __ldcg(work_n + (t & 1));
    for (int k = gwarp; k < nwork; k += nwarps) {
      const int p = __ldcg(work + (t & 1) * B + k);
      const int o = __ldg(L.set + p) >> L.shift;
      const int end = __ldg(L.start + o + 1);
      const Lane w = load_lane(L, p + lane, end);
      const int gend = group_end(L, w, p, end, t, B, lane);
      run_group<P, false, true, MAXW>(st, L, ws, sk, nullptr, hits, evs,
                                      o << L.shift, p, gend, w, t, base, B,
                                      lane);
    }
    if (t + 1 < T) {
      record_pass1(sk, L, qk, en, pos, t + 1, B, rid, nthreads, work,
                   work_n);
    }
  }
  if (gtid == 0) sk.adds[0] = adds;
}

// ---- the block form: TinyLFU in one thread block (narrow chunks)
template <int P, int MAXW>
__global__ void __launch_bounds__(1024, 1)
    block_kernel(State st, Sketch sk, const int32_t* clock0,
                 const int32_t* qk, const int32_t* sets, const uint8_t* en,
                 int T, int B, int32_t* hits_out, int32_t* evs_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_key = smem;
  int32_t* s_set = s_key + B;
  int32_t* s_way = s_set + B;               // victim way, -1: no insert
  uint8_t* s_elig = (uint8_t*)(s_way + B);  // admitted, then eligible
  uint8_t* s_first = s_elig + B;            // first eligible of its key
  __shared__ int s_hits, s_evs, s_live, s_adds;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ways = st.ways;
  if (tid == 0) {
    s_hits = 0;
    s_evs = 0;
    s_live = 0;
    s_adds = sk.adds[0];
  }
  const uint32_t c0 = (uint32_t)clock0[0];
  const uint32_t b2 = 2u * (uint32_t)B;

  for (int t = 0; t < T; ++t) {
    const uint32_t base = c0 + b2 * (uint32_t)t;
    const int off = t * B;
    for (int i = tid; i < B; i += nt) {
      s_key[i] = qk[off + i];
      s_set[i] = sets[off + i];
    }
    __syncthreads();

    // record, pass 1: reads of the pre-chunk sketch only
    int my_live = 0;
    for (int i = tid; i < B; i += nt) {
      const uint32_t k = (uint32_t)s_key[i];
      bool in_door = false;
      if (en[off + i] != 0) {
        ++my_live;
        const uint32_t dh = door_hash(sk, k);
        in_door = (sk.door[dh >> 5] >> (dh & 31u)) & 1u;
      }
      for (int r = 0; r < 4; ++r) {
        uint32_t nw = 0;
        if (in_door) {
          int64_t word;
          uint32_t shift;
          counter_pos(sk, k, r, &word, &shift);
          const uint32_t cur = sk.pk[word];
          if (((cur >> shift) & 0xFu) < 15u) nw = cur + (1u << shift);
        }
        sk.rec[(int64_t)r * B + i] = nw;
      }
    }
    if (my_live) atomicAdd(&s_live, my_live);
    __syncthreads();
    // pass 2: merge the counter words; elect each door word's last lane
    for (int i = tid; i < B; i += nt) {
      if (en[off + i] == 0) continue;
      const uint32_t k = (uint32_t)s_key[i];
      for (int r = 0; r < 4; ++r) {
        const uint32_t nw = sk.rec[(int64_t)r * B + i];
        if (nw == 0) continue;
        int64_t word;
        uint32_t shift;
        counter_pos(sk, k, r, &word, &shift);
        atomicMax(&sk.pk[word], nw);
      }
      atomicMax(&sk.door_win[door_hash(sk, k) >> 5], off + i);
    }
    __syncthreads();
    // pass 3: the elected lane sets its bit in the pre-chunk word
    for (int i = tid; i < B; i += nt) {
      if (en[off + i] == 0) continue;
      const uint32_t dh = door_hash(sk, (uint32_t)s_key[i]);
      if (sk.door_win[dh >> 5] == off + i) {
        sk.door[dh >> 5] |= 1u << (dh & 31u);
      }
    }
    if (tid == 0) {
      s_adds += s_live;
      s_live = 0;
    }
    __syncthreads();
    if (s_adds >= sk.sample) {  // aging: uniform across the block
      for (int64_t x = tid; x < 4 * (int64_t)sk.w8; x += nt) {
        sk.pk[x] = (sk.pk[x] >> 1) & 0x77777777u;
      }
      for (int x = tid; x < sk.door_words; x += nt) sk.door[x] = 0;
      __syncthreads();
      if (tid == 0) s_adds = 0;
    }
    __syncthreads();

    // admit on the pre-hit state at time base+i
    for (int i = tid; i < B; i += nt) {
      s_elig[i] = admits<P, MAXW>(st, sk, (int64_t)s_set[i] * ways, s_key[i],
                                  (int32_t)(base + i));
    }
    __syncthreads();

    // hit phase at times base+i
    int my_hits = 0;
    for (int i = tid; i < B; i += nt) {
      const int64_t row = (int64_t)s_set[i] * ways;
      const int w = probe_ways<MAXW>(st, row, s_key[i]);
      const bool on = en[off + i] != 0;
      if (w >= 0 && on) {
        ++my_hits;
        if (P == rk::LRU) atomicMax(&st.ma[row + w], (int32_t)(base + i));
        if (P == rk::LFU || P == rk::HYPERBOLIC) atomicAdd(&st.ma[row + w], 1);
      }
      s_elig[i] = w < 0 && on && s_elig[i];
    }
    if (my_hits) atomicAdd(&s_hits, my_hits);
    __syncthreads();

    // dedupe: the first eligible occurrence of a key inserts
    for (int i = tid; i < B; i += nt) {
      bool first = s_elig[i];
      for (int j = 0; first && j < i; ++j) {
        first = !(s_elig[j] && s_key[j] == s_key[i]);
      }
      s_first[i] = first;
    }
    __syncthreads();

    // same-set rank, cap, rank-th worst victim at time base+B+i
    int my_evs = 0;
    for (int i = tid; i < B; i += nt) {
      int vw = -1;
      if (s_first[i]) {
        const int32_t set = s_set[i];
        int rank = 0;
        for (int j = 0; j < i && rank < ways; ++j) {
          rank += s_first[j] && s_set[j] == set;
        }
        if (rank < ways) {
          const int64_t row = (int64_t)set * ways;
          float sc[MAXW];
          rk::row_scores<P, MAXW>(st.keys, st.ma, st.mb, row, ways,
                                  (int32_t)(base + (uint32_t)B + i), sc);
          rk::victim_order<MAXW>(sc, ways, [&](int pos, int w) {
            if (pos == rank) vw = w;
          });
          my_evs += st.keys[row + vw] != rk::kEmpty;
        }
      }
      s_way[i] = vw;
    }
    if (my_evs) atomicAdd(&s_evs, my_evs);
    __syncthreads();

    // apply the inserts, the last writer of each (set, way) only
    for (int i = tid; i < B; i += nt) {
      const int w = s_way[i];
      if (w < 0) continue;
      bool last = true;
      for (int j = i + 1; last && j < B; ++j) {
        last = !(s_way[j] == w && s_set[j] == s_set[i]);
      }
      if (last) {
        write_insert<P>(st, (int64_t)s_set[i] * ways + w, s_key[i],
                        (int32_t)(base + (uint32_t)B + i));
      }
    }
    __syncthreads();

    // per-chunk counts (the next chunk's increments follow a barrier)
    if (tid == 0) {
      hits_out[t] = s_hits;
      evs_out[t] = s_evs;
      s_hits = 0;
      s_evs = 0;
    }
  }
  if (tid == 0) sk.adds[0] = s_adds;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  State st;
  Lanes L;
  Sketch sk;
  const int32_t *clock0, *qk, *sets, *ttl, *live, *pos;
  const uint8_t* en;
  int T, B, S, cap;
  int32_t *hits, *evs, *work, *work_n;
};

int device_attr(cudaDeviceAttr what) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, what, dev);
  return v;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  if (bytes > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int P, bool TTL, int MAXW>
int launch_owners(const Args& a, cudaStream_t s) {
  const size_t smem = (size_t)kOwnerWarps * 4 *
                      scratch_ints(1 << a.L.shift, a.cap, 0);
  auto kernel = owners_kernel<P, TTL, MAXW>;
  if (const int rc = allow_smem(kernel, smem)) return rc;
  const int blocks = (a.L.owners + kOwnerWarps - 1) / kOwnerWarps;
  kernel<<<blocks, kOwnerWarps * 32, smem, s>>>(a.st, a.L, a.clock0, a.ttl,
                                                a.T, a.B, a.S, a.cap, a.hits,
                                                a.evs);
  return 0;
}

template <int P, int MAXW>
int launch_grid(const Args& a, cudaStream_t s) {
  if (!device_attr(cudaDevAttrCooperativeLaunch)) {
    return (int)cudaErrorNotSupported;
  }
  auto kernel = grid_kernel<P, MAXW>;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const size_t per_warp =
      4 * (size_t)scratch_ints(1 << a.L.shift, a.cap, (a.B + 31) / 32);
  int wpb = kGridThreads / 32;
  while (wpb > 1 && wpb * per_warp > (size_t)optin) wpb >>= 1;
  const size_t smem = wpb * per_warp;
  if (const int rc = allow_smem(kernel, smem)) return rc;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, wpb * 32, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a warp for each group of a chunk (at most min(B, owners)) and, beside
  // them, a thread for each lane of the record passes: fewer blocks make
  // cheaper barriers
  const int warps = min(a.B, a.L.owners) + (a.B + 31) / 32;
  const int blocks = min(per_sm * sms, (warps + wpb - 1) / wpb);
  State st = a.st;
  Lanes L = a.L;
  Sketch sk = a.sk;
  const int32_t* clock0 = a.clock0;
  const int32_t* qk = a.qk;
  const uint8_t* en = a.en;
  const int32_t* live = a.live;
  const int32_t* pos = a.pos;
  int T = a.T, B = a.B, cap = a.cap;
  int32_t* work = a.work;
  int32_t* work_n = a.work_n;
  int32_t* hits = a.hits;
  int32_t* evs = a.evs;
  e = cudaMemsetAsync(work_n, 0, 2 * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&st, &L, &sk, &clock0, &qk, &en, &live, &pos,
                  &T,  &B, &cap, &work, &work_n, &hits, &evs};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, blocks,
                                          wpb * 32, args, smem, s);
}

template <int P, int MAXW>
int launch_block(const Args& a, cudaStream_t s) {
  const size_t smem = (size_t)a.B * (3 * sizeof(int32_t) + 2);
  auto kernel = block_kernel<P, MAXW>;
  if (const int rc = allow_smem(kernel, smem)) return rc;
  const int threads = a.B >= 1024 ? 1024 : ((a.B + 31) / 32) * 32;
  kernel<<<1, threads, smem, s>>>(a.st, a.sk, a.clock0, a.qk, a.sets, a.en,
                                  a.T, a.B, a.hits, a.evs);
  return 0;
}

template <int P, int MAXW>
int launch_form(int form, bool ttl, const Args& a, cudaStream_t s) {
  if (form == GRID) return launch_grid<P, MAXW>(a, s);
  if (form == BLOCK) return launch_block<P, MAXW>(a, s);
  return ttl ? launch_owners<P, true, MAXW>(a, s)
             : launch_owners<P, false, MAXW>(a, s);
}

template <int MAXW>
int dispatch_policy(int policy, int form, bool ttl, const Args& a,
                    cudaStream_t s) {
  switch (policy) {
    case rk::LRU: return launch_form<rk::LRU, MAXW>(form, ttl, a, s);
    case rk::LFU: return launch_form<rk::LFU, MAXW>(form, ttl, a, s);
    case rk::FIFO: return launch_form<rk::FIFO, MAXW>(form, ttl, a, s);
    case rk::RANDOM: return launch_form<rk::RANDOM, MAXW>(form, ttl, a, s);
    case rk::HYPERBOLIC:
      return launch_form<rk::HYPERBOLIC, MAXW>(form, ttl, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bucket the n = T*B lanes by owner (set >> shift): for the enabled lanes,
// lane_out/key_out/set_out int32 [n] get the flat index, key and set of
// each, owner by owner in (t, i) order, pos_out int32 [n] each enabled
// lane's position there, and start int32 [owners+1] each owner's first
// position; live int32 [T] the enabled lanes of each chunk.  Scratch: cnt
// int32 [ceil(n/seg) * owners], tot int32 [owners].
extern "C" int replay_bucket_launch(const void* qk, const void* sets,
                                    const void* en, int n, int T, int B,
                                    int seg, int owners, int shift,
                                    void* cnt, void* tot, void* live,
                                    void* lane_out, void* key_out,
                                    void* set_out, void* pos_out,
                                    void* start, void* stream) {
  if (n < 0 || T < 0 || B < 1 || seg < 32 || seg % 32 || owners < 1 ||
      owners > 8192 || shift < 0 || (int64_t)T * B != n) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = (cudaStream_t)stream;
  const int segments = (n + seg - 1) / seg;
  auto st = (int32_t*)sets;
  auto e = (const uint8_t*)en;
  auto c = (int32_t*)cnt;
  cudaError_t rc = cudaMemsetAsync(tot, 0, sizeof(int32_t) * owners, s);
  if (rc == cudaSuccess && T > 0) {
    rc = cudaMemsetAsync(live, 0, sizeof(int32_t) * T, s);
  }
  if (rc != cudaSuccess) return (int)rc;
  const size_t hist = sizeof(int32_t) * owners;  // at most 32 KiB
  if (segments > 0) {
    bucket_count<<<segments, 256, hist, s>>>(st, e, n, B, seg, owners, shift,
                                            c, (int32_t*)tot, (int32_t*)live);
  }
  bucket_offsets<<<(owners + 1023) / 1024, 1024, hist + sizeof(int32_t), s>>>(
      c, (const int32_t*)tot, owners, segments, (int32_t*)start);
  if (segments > 0) {
    bucket_scatter<<<segments, 32, hist, s>>>(
        (const int32_t*)qk, st, e, n, seg, owners, shift, c,
        (int32_t*)lane_out, (int32_t*)key_out, (int32_t*)set_out,
        (int32_t*)pos_out);
  }
  return (int)cudaGetLastError();
}

// Replay T chunks of B lanes in place.  form 0 ("owners", flat and TTL),
// 1 ("grid", TinyLFU) and 2 ("block", TinyLFU): see the head of this file.
// `exp` null: no expiry lane; `ttl` null with an expiry lane: every insert
// never expires.  The owners and grid forms read the buckets of
// replay_bucket_launch (lane/key/set/start, owners, shift) and keep at most
// `cap` inserting lanes per group; the grid form also `live`, `pos` and the
// scratch `work` int32 [2*B + 2] (two chunks' work lists and counts).  `pk` null: no
// TinyLFU; else the sketch `pk` uint32 [4, width/8], `door` uint32
// [door_bits/32] and `adds` int32 [1] are updated in place, with the
// scratch `door_win` int32 [door_bits/32] filled with -1 and `rec` uint32
// [4, B].  TinyLFU and an expiry lane exclude each other.
extern "C" int replay_launch(void* keys, void* fpr, void* vals, void* ma,
                             void* mb, void* exp, const void* clock0,
                             const void* qk, const void* sets, const void* en,
                             const void* ttl, int T, int B, int ways, int S,
                             int policy, int form, const void* lane,
                             const void* key, const void* set,
                             const void* start, const void* live,
                             const void* pos, void* work, int owners,
                             int shift, int cap, void* hits, void* evs,
                             void* pk, void* door, void* adds, void* door_win,
                             void* rec, int width, int door_bits, int sample,
                             void* stream) {
  if (T <= 0) return 0;
  if (B < 1 || ways < 1 || ways > rk::kMaxWays || form < OWNERS ||
      form > BLOCK) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tl = pk != nullptr;
  if ((form != OWNERS) != tl || (tl && (exp != nullptr || width < 8 ||
                                        door_bits < 32))) {
    return (int)cudaErrorInvalidValue;
  }
  if (form != BLOCK && (lane == nullptr || start == nullptr || owners < 1 ||
                        cap < 1 || (form == GRID && (live == nullptr ||
                                                     pos == nullptr ||
                                                     work == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = (cudaStream_t)stream;
  Args a{State{(int32_t*)keys, (int32_t*)fpr, (int32_t*)vals, (int32_t*)ma,
               (int32_t*)mb, (int32_t*)exp, ways},
         Lanes{(const int32_t*)lane, (const int32_t*)key, (const int32_t*)set,
               (const int32_t*)start, owners, shift},
         Sketch{(uint32_t*)pk, (uint32_t*)door, (int32_t*)adds,
                (int32_t*)door_win, (uint32_t*)rec, width / 8, door_bits / 32,
                (uint32_t)width - 1u, (uint32_t)door_bits - 1u, sample},
         (const int32_t*)clock0, (const int32_t*)qk, (const int32_t*)sets,
         (const int32_t*)ttl, (const int32_t*)live, (const int32_t*)pos,
         (const uint8_t*)en, T, B, S, cap, (int32_t*)hits, (int32_t*)evs,
         (int32_t*)work, (int32_t*)work + 2 * (int64_t)B};
  if (form != BLOCK) {
    const size_t bytes = sizeof(int32_t) * (size_t)T;
    cudaError_t e = cudaMemsetAsync(hits, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(evs, 0, bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool with_ttl = exp != nullptr;
  const int rc =
      ways <= 8    ? dispatch_policy<8>(policy, form, with_ttl, a, s)
      : ways <= 16 ? dispatch_policy<16>(policy, form, with_ttl, a, s)
                   : dispatch_policy<rk::kMaxWays>(policy, form, with_ttl, a, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
