// Hopper kernel 3 of the port: a whole chunked trace replayed in ONE launch.
//
// Replaces the Pallas TPU kernel repro/kernels/replay.py: replay_resident /
// _replay_kernel (:83, :549), its flat, TTL and TinyLFU branches.
//
// The TPU kernel walked the chunks as a sequential grid with the state
// pinned in VMEM.  Here the state lives in HBM (24 MiB at 2^20 entries, so
// it stays in the 50 MB L2) and is updated in place; one persistent thread
// block walks the chunks in order, and inside a chunk its threads stride
// over the B lanes with __syncthreads() between the phases the reference
// runs one after another:
//   0. stage the chunk's keys and sets in shared memory; with an expiry
//      lane, scrub the rows this chunk touches at the chunk-exit horizon
//      (lazy scrub: an untouched row is read by nobody, and one full scrub
//      at the final horizon ends the launch, so counts and final state equal
//      the reference's eager scrub of the whole state every chunk);
//   T. with TinyLFU (never with TTLs), the admission phases of the chunked
//      replay, on a sketch that stays in HBM and is updated in place:
//      (a) record (core/admission.py record): every enabled lane reads the
//          PRE-chunk door bit and counter words and parks its 4 candidate
//          words (pre + one nibble, 0: no increment) in the global scratch
//          `rec`; only after a barrier do the counters merge by atomicMax
//          of whole uint32 words, and the last enabled lane of each door
//          word (atomicMax of a chunk-unique lane id into `door_win`, which
//          never needs a reset) ORs its bit into the pre-chunk word; then
//          `additions` grows by the enabled count and, at `sample`, every
//          counter is halved and the door cleared;
//      (b) admit: each lane peeks its victim on the PRE-hit state at time
//          base+i and estimates candidate and victim on the post-record
//          sketch; the flag is parked in s_elig, which phase 1 folds into
//          the eligibility (missing & live & admitted), so dedupe and rank
//          see admitted lanes only, as the reference's insert buffer does;
//   1. hit phase: probe, and apply on_hit to meta_a with atomicMax (LRU) or
//      atomicAdd (LFU/HYPERBOLIC), which commute and so stay exact;
//   2. dedupe: a missing enabled lane inserts only if no earlier such lane
//      has its key;
//   3. rank among earlier inserting lanes of the same set, cap at `ways`,
//      and take the rank-th worst victim of the lane's own order at its put
//      time base+B+i, on the post-hit / pre-insert state;
//   4. apply: of the lanes that chose one (set, way), only the last in batch
//      order writes (last-write-wins, as the reference's insert scatter),
//      found by atomicMax of a chunk-unique lane id into `winner`;
//   5. per-chunk hit and eviction counts.
// The state is written inside the launch, so it is never read through __ldg
// or a const __restrict__ pointer.
//
// Bound: bytes (with TinyLFU, plus the sketch words the run touches), but
// one block runs on 1 of 132 SMs and phases 2-3 scan the earlier lanes of
// the chunk (O(B^2) shared-memory reads), so this first version is
// latency-bound and far from the bound.  Sets are independent; a
// multi-block design is later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ void scrub_row(int32_t* keys, int32_t* fpr,
                                          int32_t* vals, int32_t* ma,
                                          int32_t* mb, int32_t* exp,
                                          int64_t row, int ways,
                                          int32_t horizon) {
  for (int w = 0; w < ways; ++w) {
    const int64_t x = row + w;
    if (keys[x] != rk::kEmpty && exp[x] <= horizon) {
      keys[x] = rk::kEmpty;
      fpr[x] = 0;
      vals[x] = 0;
      ma[x] = 0;
      mb[x] = 0;
      exp[x] = rk::kNoExpiry;
    }
  }
}

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

// admission.estimate: count-min minimum + the doorkeeper bit
__device__ __forceinline__ int estimate(const Sketch& sk, uint32_t k) {
  int est = 15;
  for (int r = 0; r < 4; ++r) {
    int64_t word;
    uint32_t shift;
    counter_pos(sk, k, r, &word, &shift);
    est = min(est, (int)((sk.pk[word] >> shift) & 0xFu));
  }
  const uint32_t dh = door_hash(sk, k);
  return est + (int)((sk.door[dh >> 5] >> (dh & 31u)) & 1u);
}

template <int P, bool TTL, bool TL, int MAXW>
__global__ void __launch_bounds__(1024, 1)
    replay_kernel(int32_t* keys, int32_t* fpr, int32_t* vals, int32_t* ma,
                  int32_t* mb, int32_t* exp, const int32_t* clock0,
                  const int32_t* qk, const int32_t* sets, const uint8_t* en,
                  const int32_t* ttl, int T, int B, int ways, int S,
                  int32_t* winner, int32_t* hits_out, int32_t* evs_out,
                  Sketch sk) {
  extern __shared__ int32_t smem[];
  int32_t* s_key = smem;
  int32_t* s_set = s_key + B;
  int32_t* s_way = s_set + B;                     // victim way, -1: no insert
  uint8_t* s_elig = (uint8_t*)(s_way + B);  // missing, enabled (admitted)
  uint8_t* s_first = s_elig + B;                  // first eligible of its key
  __shared__ int s_hits, s_evs, s_live, s_adds;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) {
    s_hits = 0;
    s_evs = 0;
    s_live = 0;
    if (TL) s_adds = sk.adds[0];
  }
  const uint32_t c0 = (uint32_t)clock0[0];
  const uint32_t b2 = 2u * (uint32_t)B;

  for (int t = 0; t < T; ++t) {
    const uint32_t base = c0 + b2 * (uint32_t)t;  // chunk t's clock origin
    const int32_t horizon = (int32_t)(base + b2);
    const int64_t off = (int64_t)t * B;

    // ---- 0: stage the chunk; lazy expiry scrub of the rows it touches
    for (int i = tid; i < B; i += nt) {
      s_key[i] = qk[off + i];
      s_set[i] = sets[off + i];
      if (TTL) {
        scrub_row(keys, fpr, vals, ma, mb, exp, (int64_t)s_set[i] * ways,
                  ways, horizon);
      }
    }
    __syncthreads();

    if (TL) {
      // ---- T(a) record, pass 1: reads of the pre-chunk sketch only
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
        atomicMax(&sk.door_win[door_hash(sk, k) >> 5], (int32_t)(off + i));
      }
      __syncthreads();
      // pass 3: the elected lane sets its bit in the pre-chunk word
      for (int i = tid; i < B; i += nt) {
        if (en[off + i] == 0) continue;
        const uint32_t dh = door_hash(sk, (uint32_t)s_key[i]);
        if (sk.door_win[dh >> 5] == (int32_t)(off + i)) {
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

      // ---- T(b) admit on the pre-hit state at time base+i
      for (int i = tid; i < B; i += nt) {
        const int64_t row = (int64_t)s_set[i] * ways;
        bool admit = true;
        if (rk::probe_row(keys, fpr, row, ways, s_key[i]) < 0) {
          float sc[MAXW];
          rk::row_scores<P, MAXW>(keys, ma, mb, row, ways,
                                  (int32_t)(base + i), sc);
          int vw = 0;
          float best = sc[0];
          rk::for_ways<MAXW>(ways, [&](int w) {
            if (sc[w] < best) {
              best = sc[w];
              vw = w;
            }
          });
          const int32_t vkey = keys[row + vw];
          if (vkey != rk::kEmpty) {
            admit = estimate(sk, (uint32_t)s_key[i]) >
                    estimate(sk, (uint32_t)vkey);
          }
        }
        s_elig[i] = admit;
      }
      __syncthreads();
    }

    // ---- 1: hit phase at times base+i
    int my_hits = 0;
    for (int i = tid; i < B; i += nt) {
      const int64_t row = (int64_t)s_set[i] * ways;
      const int w = rk::probe_row(keys, fpr, row, ways, s_key[i]);
      const bool live = en[off + i] != 0;
      if (w >= 0 && live) {
        ++my_hits;
        if (P == rk::LRU) atomicMax(&ma[row + w], (int32_t)(base + i));
        if (P == rk::LFU || P == rk::HYPERBOLIC) atomicAdd(&ma[row + w], 1);
      }
      s_elig[i] = w < 0 && live && (!TL || s_elig[i]);
    }
    if (my_hits) atomicAdd(&s_hits, my_hits);
    __syncthreads();

    // ---- 2: dedupe — the first eligible occurrence of a key inserts
    for (int i = tid; i < B; i += nt) {
      bool first = s_elig[i];
      if (first) {
        const int32_t key = s_key[i];
        for (int j = 0; j < i; ++j) {
          if (s_elig[j] && s_key[j] == key) {
            first = false;
            break;
          }
        }
      }
      s_first[i] = first;
    }
    __syncthreads();

    // ---- 3: same-set rank, cap, rank-th worst victim at time base+B+i
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
          rk::row_scores<P, MAXW>(keys, ma, mb, row, ways,
                                  (int32_t)(base + (uint32_t)B + i), sc);
          rk::victim_order<MAXW>(sc, ways, [&](int pos, int w) {
            if (pos == rank) vw = w;
          });
          my_evs += keys[row + vw] != rk::kEmpty;
          atomicMax(&winner[row + vw], (int32_t)(off + i));
        }
      }
      s_way[i] = vw;
    }
    if (my_evs) atomicAdd(&s_evs, my_evs);
    __syncthreads();

    // ---- 4: apply the inserts, last writer of each (set, way) only
    for (int i = tid; i < B; i += nt) {
      const int w = s_way[i];
      if (w < 0) continue;
      const int64_t x = (int64_t)s_set[i] * ways + w;
      if (winner[x] != (int32_t)(off + i)) continue;
      const int32_t key = s_key[i];
      const int32_t t_put = (int32_t)(base + (uint32_t)B + i);
      keys[x] = key;
      fpr[x] = rk::fingerprint(key);
      vals[x] = key;  // replay payload convention: val == key
      if (P == rk::LRU || P == rk::FIFO) {
        ma[x] = t_put;
        mb[x] = 0;
      } else if (P == rk::RANDOM) {
        ma[x] = 0;
        mb[x] = 0;
      } else {  // LFU: (1, 0); HYPERBOLIC: (n=1, t0=now)
        ma[x] = 1;
        mb[x] = P == rk::HYPERBOLIC ? t_put : 0;
      }
      if (TTL) {
        const int32_t tt = ttl ? ttl[off + i] : 0;
        exp[x] = tt > 0 ? (int32_t)((uint32_t)horizon + (uint32_t)tt)
                        : rk::kNoExpiry;
      }
    }
    __syncthreads();

    // ---- 5: per-chunk counts (phase 1 of the next chunk runs after the
    // next __syncthreads, so the reset is ordered before its increments)
    if (tid == 0) {
      hits_out[t] = s_hits;
      evs_out[t] = s_evs;
      s_hits = 0;
      s_evs = 0;
    }
  }

  if (TL && tid == 0) sk.adds[0] = s_adds;
  if (TTL && T > 0) {  // the scrub of rows no chunk touched, at the end
    const int32_t horizon = (int32_t)(c0 + b2 * (uint32_t)T);
    __syncthreads();
    for (int64_t r = tid; r < (int64_t)S; r += nt) {
      scrub_row(keys, fpr, vals, ma, mb, exp, r * ways, ways, horizon);
    }
  }
}

template <int P, bool TTL, bool TL, int MAXW>
int launch(int32_t* keys, int32_t* fpr, int32_t* vals, int32_t* ma,
           int32_t* mb, int32_t* exp, const int32_t* clock0,
           const int32_t* qk, const int32_t* sets, const uint8_t* en,
           const int32_t* ttl, int T, int B, int ways, int S,
           int32_t* winner, int32_t* hits, int32_t* evs, const Sketch& sk,
           cudaStream_t s) {
  const size_t smem = (size_t)B * (3 * sizeof(int32_t) + 2);
  auto kernel = replay_kernel<P, TTL, TL, MAXW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = B >= 1024 ? 1024 : ((B + 31) / 32) * 32;
  kernel<<<1, threads, smem, s>>>(keys, fpr, vals, ma, mb, exp, clock0, qk,
                                  sets, en, ttl, T, B, ways, S, winner, hits,
                                  evs, sk);
  return 0;
}

template <bool TTL, bool TL, int MAXW>
int dispatch_policy(int policy, int32_t* keys, int32_t* fpr, int32_t* vals,
                    int32_t* ma, int32_t* mb, int32_t* exp,
                    const int32_t* clock0, const int32_t* qk,
                    const int32_t* sets, const uint8_t* en,
                    const int32_t* ttl, int T, int B, int ways, int S,
                    int32_t* winner, int32_t* hits, int32_t* evs,
                    const Sketch& sk, cudaStream_t s) {
#define RK_REPLAY(P)                                                        \
  return launch<P, TTL, TL, MAXW>(keys, fpr, vals, ma, mb, exp, clock0,    \
                                  qk, sets, en, ttl, T, B, ways, S,        \
                                  winner, hits, evs, sk, s)
  switch (policy) {
    case rk::LRU: RK_REPLAY(rk::LRU);
    case rk::LFU: RK_REPLAY(rk::LFU);
    case rk::FIFO: RK_REPLAY(rk::FIFO);
    case rk::RANDOM: RK_REPLAY(rk::RANDOM);
    case rk::HYPERBOLIC: RK_REPLAY(rk::HYPERBOLIC);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RK_REPLAY
}

template <bool TTL, bool TL>
int dispatch_ways(int policy, int32_t* keys, int32_t* fpr, int32_t* vals,
                  int32_t* ma, int32_t* mb, int32_t* exp,
                  const int32_t* clock0, const int32_t* qk,
                  const int32_t* sets, const uint8_t* en, const int32_t* ttl,
                  int T, int B, int ways, int S, int32_t* winner,
                  int32_t* hits, int32_t* evs, const Sketch& sk,
                  cudaStream_t s) {
  if (ways <= 16) {
    return dispatch_policy<TTL, TL, 16>(policy, keys, fpr, vals, ma, mb, exp,
                                        clock0, qk, sets, en, ttl, T, B,
                                        ways, S, winner, hits, evs, sk, s);
  }
  return dispatch_policy<TTL, TL, rk::kMaxWays>(
      policy, keys, fpr, vals, ma, mb, exp, clock0, qk, sets, en, ttl, T, B,
      ways, S, winner, hits, evs, sk, s);
}

}  // namespace

// `exp` null: no expiry lane.  `ttl` null with an expiry lane: every insert
// never expires.  `winner` is int32 [S*ways], filled with -1 by the caller.
// `pk` null: no TinyLFU; else the sketch `pk` uint32 [4, width/8], `door`
// uint32 [door_bits/32] and `adds` int32 [1] are updated in place, with the
// scratch `door_win` int32 [door_bits/32] filled with -1 and `rec` uint32
// [4, B].  TinyLFU and an expiry lane exclude each other.
extern "C" int replay_launch(void* keys, void* fpr, void* vals, void* ma,
                             void* mb, void* exp, const void* clock0,
                             const void* qk, const void* sets, const void* en,
                             const void* ttl, int T, int B, int ways, int S,
                             int policy, void* winner, void* hits, void* evs,
                             void* pk, void* door, void* adds, void* door_win,
                             void* rec, int width, int door_bits, int sample,
                             void* stream) {
  if (T <= 0) return 0;
  if (B < 1 || ways < 1 || ways > rk::kMaxWays) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tl = pk != nullptr;
  if (tl && (exp != nullptr || width < 8 || door_bits < 32)) {
    return (int)cudaErrorInvalidValue;
  }
  Sketch sk{(uint32_t*)pk,
            (uint32_t*)door,
            (int32_t*)adds,
            (int32_t*)door_win,
            (uint32_t*)rec,
            width / 8,
            door_bits / 32,
            (uint32_t)width - 1u,
            (uint32_t)door_bits - 1u,
            sample};
  auto k = (int32_t*)keys;
  auto f = (int32_t*)fpr;
  auto v = (int32_t*)vals;
  auto a = (int32_t*)ma;
  auto b = (int32_t*)mb;
  auto x = (int32_t*)exp;
  auto c = (const int32_t*)clock0;
  auto q = (const int32_t*)qk;
  auto st = (const int32_t*)sets;
  auto e = (const uint8_t*)en;
  auto tt = (const int32_t*)ttl;
  auto wn = (int32_t*)winner;
  auto h = (int32_t*)hits;
  auto ev = (int32_t*)evs;
  auto s = (cudaStream_t)stream;
  int rc;
  if (x != nullptr) {
    rc = dispatch_ways<true, false>(policy, k, f, v, a, b, x, c, q, st, e,
                                    tt, T, B, ways, S, wn, h, ev, sk, s);
  } else if (tl) {
    rc = dispatch_ways<false, true>(policy, k, f, v, a, b, x, c, q, st, e,
                                    tt, T, B, ways, S, wn, h, ev, sk, s);
  } else {
    rc = dispatch_ways<false, false>(policy, k, f, v, a, b, x, c, q, st, e,
                                     tt, T, B, ways, S, wn, h, ev, sk, s);
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
