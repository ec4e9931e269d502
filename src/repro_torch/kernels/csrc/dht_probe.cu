// dht_lookup and dht_insert: the open-addressed dual-lane hash table.
//
// Replace the Pallas kernels repro/kernels/dht_probe.py:dht_lookup (body
// `_lookup_kernel`) and :dht_insert (body `_insert_kernel`), whose jnp
// oracles are repro/core/dht.py:lookup_jnp and :insert_jnp.
//
// dht_lookup: bound on the H100 by bytes, `valid` read and the slots
// written for every row (5 bytes a row), the key lanes of the valid rows
// only and 9 bytes a slot examined; on the assembly paths a call has 2^21
// to 2^23 rows, a tenth or less of them valid, and the table (9 bytes a
// slot, 2^21 to 2^23 slots) does not stay in the 50 MB L2.  The design:
//   * a warp streams a tile of 512 rows: one 16-byte load of `valid` a
//     lane, the tile's valid rows compacted into a list in shared memory
//     (a warp scan of the lanes' counts), and the tile's slots stored as
//     16-byte runs, lane after lane, -1 where a row is invalid or absent;
//     a ragged end or an unaligned pointer takes a scalar edge path;
//   * lanes take the valid rows round-robin, kInFlight at once, and issue
//     every row's key lanes, then every row's slot loads, before any
//     compare; a probe step loads used, slot_hi and slot_lo together
//     (repro::slot_load), one round trip where repro::probe takes two;
//   * max_probe is read once a block.
// Against one thread a query with the same fused step
// (kernels/probe_variants.py, variant `thread`) it wins on the sparse
// calls and on paths 1-2's dense ones, and loses on path 3's dense ones
// (2^21 rows, 42% valid).
//
// dht_insert: bulk-synchronous claim rounds.  The race is global, so keys
// cannot be tiled inside a block: which key wins a slot decides where later
// keys land.  Per round every pending key looks at its slot as the table
// stood at the round's start: a slot holding the key itself finishes it
// (dedupe); keys on an empty slot race and the highest batch index wins and
// writes it; a key on a slot holding a different key advances one slot; a
// race loser retries the same slot next round.  A key that has probed cap
// slots is exhausted (slot -1) and stops no one else.
//
// Bound on the H100: bytes for the streaming pass over the batch (valid
// read, slots written: 5 bytes a row) and the table copy; the rounds after
// it are latency-bound chains of dependent gathers and atomics over the
// valid keys only.  The design:
//   * one cooperative launch runs everything: the new table (a copy of the
//     input, owner -1), a streaming pass over the n rows (16-byte loads of
//     `valid`, 16-byte stores of slot -1) that appends each valid row's
//     batch index to a compact worklist, then all rounds, with grid
//     barriers between claim and resolve; the pending count lives on the
//     device and the host reads nothing until the end.  The next lists
//     hold batch index and slot; round 1 hashes the key it gathers anyway;
//   * the worklist shrinks: claim finishes the keys that met themselves,
//     moves those that met another key to the next list, and puts the
//     empty-slot bidders on a bid list; resolve reads the bid list only,
//     writes the winners, finishes the losers whose winner holds their own
//     key (a duplicated batch: the reference finishes them next round on
//     that slot, where they change nothing else) and appends the other
//     losers to the next list.  A round costs O(pending keys), and scratch
//     is 24 bytes a valid key, not per-row state for every row;
//   * every store writes runs: the slot fill goes lane after lane, and list
//     appends are placed with ballots, one atomic per block and tile;
//   * each thread takes 4 entries a tile, their loads issued stage by stage
//     before any store, so the dependent gathers overlap;
//   * once at most four tiles of keys pend, block 0 finishes the rounds
//     alone with block barriers (the long tail of a loaded table's probe
//     chains) and the other blocks leave;
//   * probes are not stored: a pending key has probed (slot - h0) & (cap-1)
//     slots, h0 = hash & (cap-1), and is exhausted when its next slot is h0.
// Bids use the batch index, so the winners are the reference's and the
// order of the worklist never matters.  owner[slot] is not reset: a slot
// that saw bids is used from then on, and no key bids on a used slot.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// dht_insert
constexpr int kInsertThreads = 256;
constexpr int kInsertWarps = kInsertThreads / 32;
constexpr int kItems = 4;                          // worklist entries a thread takes
constexpr int kTile = kInsertThreads * kItems;     // ... and a block
constexpr int kRowsPerThread = 16;                 // streaming pass: one 16-byte load
constexpr int kStreamTile = kInsertThreads * kRowsPerThread;
constexpr int kSoloKeys = 4 * kTile;               // block 0 alone at or below

// Device counters of one insert (int32, zeroed by the caller), in order,
// and the names the wrapper reads them by (dht_insert_counter_names).
#define INSERT_COUNTERS(X)                                           \
  X(kValid, valid)          /* valid rows (the count pass) */        \
  X(kList, list0)           /* kList + round % 3: keys pending */    \
  X(kList1, list1)                                                   \
  X(kList2, list2)                                                   \
  X(kBid, bid0)             /* kBid + round % 2: bidders */          \
  X(kBid1, bid1)                                                     \
  X(kError, error)          /* 1 = the rounds did not converge */    \
  X(kRounds, rounds)        /* rounds run */                         \
  X(kAfterFirst, pending_after_round_1)

enum Counter {
#define X(id, name) id,
  INSERT_COUNTERS(X)
#undef X
  kCounters
};

// dht_lookup: a warp streams a tile of 512 rows (16 a lane), then probes
// the tile's valid rows only, several in flight a lane.
constexpr int kLookupThreads = 256;
constexpr int kLookupWarps = kLookupThreads / 32;
constexpr int kTileRows = 32 * 16;
constexpr int kInFlight = 4;  // valid rows a lane probes at once

// Bit b of the result: byte b of the 16 is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 w) {
  uint32_t m = 0;
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t x = __vcmpne4(words[q], 0u) & 0x80808080u;
    m |= ((x >> 7 | x >> 14 | x >> 21 | x >> 28) & 0xFu) << (4 * q);
  }
  return m;
}

__global__ void __launch_bounds__(kLookupThreads)
    lookup_kernel(const uint32_t* __restrict__ slot_hi,
                  const uint32_t* __restrict__ slot_lo,
                  const uint8_t* __restrict__ used,
                  const int32_t* __restrict__ max_probe, uint32_t cap_mask,
                  const uint32_t* __restrict__ qhi,
                  const uint32_t* __restrict__ qlo,
                  const uint8_t* __restrict__ qvalid, long long n,
                  int32_t* __restrict__ out) {
  __shared__ uint16_t s_rows[kLookupWarps][kTileRows];  // valid rows
  __shared__ int4 s_out[kLookupWarps][kTileRows / 4];   // the tile's slots
  __shared__ int32_t s_bound;
  if (threadIdx.x == 0) s_bound = __ldg(max_probe) + 1;
  __syncthreads();
  const int32_t bound = s_bound;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vin = ((uintptr_t)qvalid & 15) == 0;
  const bool vout = ((uintptr_t)out & 15) == 0;
  uint16_t* rows = s_rows[warp];
  int4* res4 = s_out[warp];
  int32_t* res = (int32_t*)res4;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  for (long long t = (long long)blockIdx.x * kLookupWarps + warp; t < tiles;
       t += (long long)gridDim.x * kLookupWarps) {
    const long long t0 = t * kTileRows;
    // 1. the valid bytes of this lane's 16 rows, one 16-byte load
    const long long r0 = t0 + 16 * lane;
    uint32_t bits = 0;
    if (vin && r0 + 16 <= n) {
      bits = nonzero_bytes(__ldcs((const uint4*)(qvalid + r0)));
    } else {
      for (int b = 0; b < 16 && r0 + b < n; ++b)
        bits |= (uint32_t)(qvalid[r0 + b] != 0) << b;
    }
    // 2. the tile's valid rows in a list, lane after lane; every slot -1
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int pos = incl - cnt;
    for (uint32_t b = bits; b; b &= b - 1)
      rows[pos++] = (uint16_t)(16 * lane + __ffs(b) - 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) res4[32 * q + lane] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    // 3. lanes take the valid rows round-robin, kInFlight at once: every
    // row's key lanes, then every row's slot loads, before any compare
    for (int j0 = 0; j0 < total; j0 += 32 * kInFlight) {
      int row[kInFlight];
      bool live[kInFlight];
      uint32_t khi[kInFlight], klo[kInFlight], a[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int j = j0 + 32 * k + lane;
        live[k] = j < total;
        row[k] = live[k] ? rows[j] : 0;
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        khi[k] = live[k] ? __ldg(qhi + t0 + row[k]) : 0u;
        klo[k] = live[k] ? __ldg(qlo + t0 + row[k]) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k)
        a[k] = repro::kmer_hash(khi[k], klo[k]) & cap_mask;
      for (int32_t step = 0; step <= bound; ++step) {
        uint3 v[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
          v[k] = live[k] ? repro::slot_load(slot_hi, slot_lo, used, a[k])
                         : make_uint3(0u, 0u, 0u);
        bool more = false;
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (!live[k]) continue;
          const int s = repro::slot_match(v[k].x, v[k].y, v[k].z, khi[k],
                                          klo[k]);
          if (s == repro::kSlotKey) res[row[k]] = (int32_t)a[k];
          live[k] = s == repro::kSlotNext;
          a[k] = (a[k] + 1) & cap_mask;
          more |= live[k];
        }
        if (!more) break;
      }
    }
    __syncwarp();
    // 4. the tile's slots, 16 bytes a lane, lane after lane
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * (32 * q + lane);
      if (vout && t0 + r + 4 <= n) {
        __stcs((int4*)(out + t0 + r), res4[32 * q + lane]);
      } else {
        for (int b = 0; b < 4 && t0 + r + b < n; ++b)
          out[t0 + r + b] = res[r + b];
      }
    }
    __syncwarp();  // rows and res are reused by the next tile
  }
}

// Valid rows of the batch: four 16-byte loads a thread in flight, lane
// after lane, and one atomic per block.
__global__ void insert_count_kernel(const uint8_t* __restrict__ kvalid,
                                    long long n, int32_t* __restrict__ ctr) {
  __shared__ int warp_sums[kThreads / 32];
  const bool vec = ((uintptr_t)kvalid & 15) == 0;
  const long long chunks = (n + 15) / 16;
  int c = 0;
  for (long long c0 = (long long)blockIdx.x * blockDim.x * 4; c0 < chunks;
       c0 += (long long)gridDim.x * blockDim.x * 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long r0 = 16 * (c0 + q * blockDim.x + threadIdx.x);
      if (vec && r0 + 16 <= n) {
        const uint4 w = __ldcs((const uint4*)(kvalid + r0));
        c += (__popc(__vcmpne4(w.x, 0u)) + __popc(__vcmpne4(w.y, 0u)) +
              __popc(__vcmpne4(w.z, 0u)) + __popc(__vcmpne4(w.w, 0u))) >> 3;
      } else {
        for (long long i = r0; i < n && i < r0 + 16; ++i) c += kvalid[i] != 0;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(ctr, s);
  }
}

struct Table {  // the input table, copied into the output one
  const uint32_t* slot_hi;
  const uint32_t* slot_lo;
  const uint8_t* used;
  const int32_t* max_probe;
};

struct Worklist {
  int32_t* idx;  // batch index of the key
  int32_t* at;   // the slot it looks at
};

// Reserves room for each thread's entries in two lists (counts a and b,
// packed as a | b << 16; a block's total stays below 2^16): a block-wide
// exclusive scan and one atomicAdd per list.  Returns this thread's first
// position in each list.  Every thread of the block calls it; the callers
// pass each warp's total on lane 0 and 0 elsewhere, and place the warp's
// entries with ballots, so that each store instruction writes one run.
__device__ __forceinline__ int2 block_reserve(int packed, int32_t* ctr_a,
                                              int32_t* ctr_b, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // sh is reused tile after tile
  int x = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kInsertWarps ? sh[lane] : 0;
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kInsertWarps) sh[lane] = s - w;
    if (lane == 31) {
      const int ta = s & 0xFFFF, tb = s >> 16;
      sh[kInsertWarps] = ta ? atomicAdd(ctr_a, ta) : 0;
      sh[kInsertWarps + 1] = tb ? atomicAdd(ctr_b, tb) : 0;
    }
  }
  __syncthreads();
  const int ex = sh[warp] + x - packed;
  return make_int2(sh[kInsertWarps] + (ex & 0xFFFF),
                   sh[kInsertWarps + 1] + (ex >> 16));
}

__device__ __forceinline__ uint32_t home(uint32_t hi, uint32_t lo,
                                         uint32_t cap_mask) {
  return repro::kmer_hash(hi, lo) & cap_mask;
}

// The whole insert in one cooperative launch.  Table arrays, owner, the
// lists and the counters change during the kernel: they are read through
// L2 (__ldcg), never through the non-coherent L1 or read-only paths.  Each
// thread takes kItems entries of a tile stage by stage (all list loads,
// then all slot loads, then the dependent loads, then the stores), so the
// items' load chains overlap.
__global__ void __launch_bounds__(kInsertThreads, 3)
    insert_kernel(Table in, const uint32_t* __restrict__ khi,
                  const uint32_t* __restrict__ klo,
                  const uint8_t* __restrict__ kvalid, long long n,
                  long long cap, uint32_t* slot_hi, uint32_t* slot_lo,
                  uint8_t* used, int32_t* owner, int32_t* max_probe,
                  int32_t* slots, Worklist list0, Worklist list1,
                  Worklist bids, int32_t* ctr) {
  __shared__ int sh[kInsertWarps + 2];
  cg::grid_group grid = cg::this_grid();
  const uint32_t cap_mask = (uint32_t)(cap - 1);
  const int tid = threadIdx.x;
  const bool stats = blockIdx.x == 0 && tid == 0;  // keeps the counters
  uint32_t pmax = 0;  // this thread's most probes of a finished key

  // ---- the new table: a copy of the input; owner -1 ----
  {
    const long long stride = (long long)gridDim.x * kInsertThreads;
    const long long first = (long long)blockIdx.x * kInsertThreads + tid;
    const bool vec16 = (cap & 15) == 0 &&
                       (((uintptr_t)in.slot_hi | (uintptr_t)in.slot_lo |
                         (uintptr_t)in.used) & 15) == 0;
    if (vec16) {  // 16-byte words: four slots of the key lanes, 16 of used
      for (long long q = first; q < cap / 4; q += stride) {
        ((uint4*)slot_hi)[q] = __ldcs((const uint4*)in.slot_hi + q);
        ((uint4*)slot_lo)[q] = __ldcs((const uint4*)in.slot_lo + q);
        ((int4*)owner)[q] = make_int4(-1, -1, -1, -1);
        if (q < cap / 16) ((uint4*)used)[q] = __ldcs((const uint4*)in.used + q);
      }
    } else {
      for (long long a = first; a < cap; a += stride) {
        slot_hi[a] = in.slot_hi[a];
        slot_lo[a] = in.slot_lo[a];
        used[a] = in.used[a];
        owner[a] = -1;
      }
    }
    if (stats) *max_probe = *in.max_probe;
  }

  // ---- streaming pass: slot -1 for every row, valid rows to list 0 ----
  // Its loads and stores are marked evict-first: the rounds want the table
  // in L2, not the stream.  A thread loads 16 rows' flags; the warp reads
  // them back from shared memory a row per lane (rows L, L + 32, ... of
  // its 512), so the list is in row order and each store writes one run.
  __shared__ __align__(16) uint8_t flags[kStreamTile];
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1;
  const bool vec = ((uintptr_t)kvalid & 15) == 0;
  uint8_t* wflags = flags + 32 * kRowsPerThread * warp;  // the warp's rows
  for (long long t = blockIdx.x; t * kStreamTile < n; t += gridDim.x) {
    const long long tile0 = t * kStreamTile;
    const long long w0 = tile0 + 32 * kRowsPerThread * warp;
    const long long r0 = tile0 + (long long)tid * kRowsPerThread;
    __syncwarp();  // the warp's flags of the last tile are read
    uint4 w = make_uint4(0, 0, 0, 0);
    if (vec && tile0 + kStreamTile <= n) {
      w = __ldcs((const uint4*)(kvalid + r0));
      int4* s4 = (int4*)(slots + w0);  // lane after lane
#pragma unroll
      for (int q = 0; q < kRowsPerThread / 4; ++q)
        __stcs(s4 + 32 * q + lane, make_int4(-1, -1, -1, -1));
    } else {
      uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (r0 + j < n) {
          words[j >> 2] |= (uint32_t)kvalid[r0 + j] << (8 * (j & 3));
          slots[r0 + j] = -1;
        }
      }
      w = make_uint4(words[0], words[1], words[2], words[3]);
    }
    ((uint4*)flags)[tid] = w;
    if (!__syncthreads_or(w.x | w.y | w.z | w.w)) continue;  // none valid
    uint32_t bits = 0;  // bit j: row w0 + lane + 32 j is valid
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      bits |= (uint32_t)(wflags[lane + 32 * j] != 0) << j;
    int total = 0;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      total += __popc(__ballot_sync(0xffffffffu, (bits >> j) & 1));
    int p = block_reserve(lane == 0 ? total : 0, ctr + kList, ctr + kList, sh).x;
    p = __shfl_sync(0xffffffffu, p, 0);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, (bits >> j) & 1);
      if ((bits >> j) & 1)
        list0.idx[p + __popc(m & lanes_below)] = (int32_t)(w0 + lane + 32 * j);
      p += __popc(m);
    }
  }
  grid.sync();

  // ---- the rounds ----
  // Each key finishes within 2 rounds per slot it probes, and probes at
  // most cap slots.
  const long long max_rounds = 2 * cap + 2;
  bool solo = false;  // block 0 alone, with block barriers
  int nblk = gridDim.x;
  for (long long r = 0;; ++r) {
    const Worklist cur = (r & 1) ? list1 : list0;
    const Worklist nxt = (r & 1) ? list0 : list1;
    int32_t* n_next = ctr + kList + (r + 1) % 3;
    int32_t* n_bid = ctr + kBid + (r & 1);

    // claim: against the table as it stood at the round's start.  The list
    // is taken from its end: higher batch indices bid first, and a copy of
    // a key that finds a higher bid on its slot already skips the atomic
    const long long ncur = __ldcg(ctr + kList + r % 3);
    if (ncur == 0) break;  // no valid key at all
    for (long long base = (long long)blockIdx.x * kTile; base < ncur;
         base += (long long)nblk * kTile) {
      int32_t ii[kItems];
      uint32_t aa[kItems], kh[kItems], kl[kItems], sh_hi[kItems], sh_lo[kItems];
      bool live[kItems], u[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long e = ncur - 1 - (base + j * kInsertThreads + tid);
        live[j] = e >= 0;
        ii[j] = live[j] ? __ldcg(cur.idx + e) : 0;
        if (r == 0) {  // list 0 holds no slots: each key starts at home
          kh[j] = live[j] ? khi[ii[j]] : 0;
          kl[j] = live[j] ? klo[ii[j]] : 0;
          aa[j] = home(kh[j], kl[j], cap_mask);
        } else {
          aa[j] = live[j] ? (uint32_t)__ldcg(cur.at + e) : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) u[j] = live[j] && __ldcg(used + aa[j]);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (u[j]) {
          if (r != 0) kh[j] = khi[ii[j]], kl[j] = klo[ii[j]];
          sh_hi[j] = __ldcg(slot_hi + aa[j]);
          sh_lo[j] = __ldcg(slot_lo + aa[j]);
        }
      }
      int kind[kItems];  // 0 finished, 1 next list, 2 bid list
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        kind[j] = 0;
        if (u[j]) {
          const uint32_t h0 = home(kh[j], kl[j], cap_mask);
          if (sh_hi[j] == kh[j] && sh_lo[j] == kl[j]) {
            slots[ii[j]] = (int32_t)aa[j];  // met itself
            pmax = max(pmax, (aa[j] - h0) & cap_mask);
          } else if (((aa[j] + 1) & cap_mask) == h0) {
            pmax = max(pmax, (uint32_t)cap);  // exhausted: stays -1
          } else {
            aa[j] = (aa[j] + 1) & cap_mask;
            kind[j] = 1;
          }
        } else if (live[j]) {
          if (__ldcg(owner + aa[j]) < ii[j]) atomicMax(owner + aa[j], ii[j]);
          kind[j] = 2;
        }
      }
      int nn = 0, nb = 0;  // the warp's entries for each list
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        nn += __popc(__ballot_sync(0xffffffffu, kind[j] == 1));
        nb += __popc(__ballot_sync(0xffffffffu, kind[j] == 2));
      }
      int2 p = block_reserve(lane == 0 ? (nn | nb << 16) : 0, n_next, n_bid, sh);
      p.x = __shfl_sync(0xffffffffu, p.x, 0);
      p.y = __shfl_sync(0xffffffffu, p.y, 0);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned mn = __ballot_sync(0xffffffffu, kind[j] == 1);
        const unsigned mb = __ballot_sync(0xffffffffu, kind[j] == 2);
        if (kind[j] == 1) {
          const int q = p.x + __popc(mn & lanes_below);
          nxt.idx[q] = ii[j], nxt.at[q] = (int32_t)aa[j];
        } else if (kind[j] == 2) {
          const int q = p.y + __popc(mb & lanes_below);
          bids.idx[q] = ii[j], bids.at[q] = (int32_t)aa[j];
        }
        p.x += __popc(mn);
        p.y += __popc(mb);
      }
    }
    if (blockIdx.x == 0 && tid == 0) ctr[kBid + ((r + 1) & 1)] = 0;
    if (solo) __syncthreads(); else grid.sync();

    // resolve: the highest bidder writes the slot.  A loser whose winner
    // holds the same key finishes on that slot now: next round it would
    // meet itself there and do nothing else.  The other losers retry it.
    const long long nbid = __ldcg(n_bid);
    for (long long base = (long long)blockIdx.x * kTile; base < nbid;
         base += (long long)nblk * kTile) {
      int32_t ii[kItems], aa[kItems], own[kItems];
      bool live[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long e = base + j * kInsertThreads + tid;
        live[j] = e < nbid;
        ii[j] = live[j] ? __ldcg(bids.idx + e) : 0;
        aa[j] = live[j] ? __ldcg(bids.at + e) : 0;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        own[j] = live[j] ? __ldcg(owner + aa[j]) : 0;  // >= every bid
      uint32_t kh[kItems], kl[kItems], wh[kItems], wl[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (live[j]) kh[j] = khi[ii[j]], kl[j] = klo[ii[j]];
        if (live[j] && own[j] != ii[j]) wh[j] = khi[own[j]], wl[j] = klo[own[j]];
      }
      bool retry[kItems];
      int nn = 0;  // the warp's losers that retry
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool won = live[j] && own[j] == ii[j];
        const bool twin = live[j] && !won && wh[j] == kh[j] && wl[j] == kl[j];
        retry[j] = live[j] && !won && !twin;
        if (won) {
          slot_hi[aa[j]] = kh[j];
          slot_lo[aa[j]] = kl[j];
          used[aa[j]] = 1;
        }
        if (won || twin) {
          slots[ii[j]] = aa[j];
          pmax = max(pmax, ((uint32_t)aa[j] - home(kh[j], kl[j], cap_mask)) &
                               cap_mask);
        }
        nn += __popc(__ballot_sync(0xffffffffu, retry[j]));
      }
      int p = block_reserve(lane == 0 ? nn : 0, n_next, n_next, sh).x;
      p = __shfl_sync(0xffffffffu, p, 0);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned m = __ballot_sync(0xffffffffu, retry[j]);
        if (retry[j]) {
          const int q = p + __popc(m & lanes_below);
          nxt.idx[q] = ii[j], nxt.at[q] = aa[j];
        }
        p += __popc(m);
      }
    }
    if (blockIdx.x == 0 && tid == 0) ctr[kList + (r + 2) % 3] = 0;
    if (solo) __syncthreads(); else grid.sync();

    // every thread reads the same count: it changes two rounds later
    const int32_t left = __ldcg(n_next);
    if (stats) {
      if (r == 0) ctr[kAfterFirst] = left;
      ctr[kRounds] = (int32_t)(r + 1);
      if (left > 0 && r + 1 > max_rounds) ctr[kError] = 1;
    }
    if (left == 0 || r + 1 > max_rounds) break;
    if (!solo && left <= kSoloKeys) {
      solo = true;
      nblk = 1;
      if (blockIdx.x != 0) break;
    }
  }

  // max_probe = max(old, every finished key's probes): one atomic a block
  for (int off = 16; off > 0; off >>= 1)
    pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
  __syncthreads();
  if ((tid & 31) == 0) sh[tid >> 5] = (int)pmax;
  __syncthreads();
  if (tid == 0) {
    uint32_t m = 0;
    for (int w = 0; w < kInsertWarps; ++w) m = max(m, (uint32_t)sh[w]);
    if (m) atomicMax((unsigned int*)max_probe, m);
  }
}

}  // namespace

// max_probe [1] on the device.
extern "C" int dht_lookup_launch(const void* slot_hi, const void* slot_lo,
                                 const void* used, const void* max_probe,
                                 long long cap, const void* qhi,
                                 const void* qlo, const void* qvalid,
                                 long long n, void* out, void* stream) {
  if (n == 0) return 0;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = (tiles + kLookupWarps - 1) / kLookupWarps;
  lookup_kernel<<<(unsigned)blocks, kLookupThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
      (const uint8_t*)used, (const int32_t*)max_probe, (uint32_t)(cap - 1),
      (const uint32_t*)qhi, (const uint32_t*)qlo, (const uint8_t*)qvalid, n,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* dht_insert_counter_names() {
#define X(id, name) #name " "
  return INSERT_COUNTERS(X);
#undef X
}

// Counts the valid rows into counters[0] (counters zeroed by the caller);
// the caller reads it back to size the worklists.
extern "C" int dht_insert_count_launch(const void* kvalid, long long n,
                                       void* counters, void* stream) {
  if (n == 0) return 0;
  const long long chunks = (n + 15) / 16;
  long long blocks = (chunks + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > 1024) blocks = 1024;  // grid-stride: few atomics
  insert_count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)kvalid, n, (int32_t*)counters + kValid);
  return (int)cudaGetLastError();
}

// Inserts keys into a new table (slot_hi, slot_lo, used, max_probe, which
// the kernel fills from in_* first), in one cooperative launch.  slots [n]
// int32 (16-byte aligned) receives each key's slot.  Scratch, allocated by
// the caller: owner [cap] int32 (the kernel sets it to -1), lists [6, m]
// int32 for m = the valid count (two worklists and the bid list, each as
// batch index and slot), counters [kCounters] int32 zeroed.  max_probe [1]
// ends as max(in_mp, the most probes of any key).  The grid is every block
// that can be co-resident on the card.  The caller reads counters[kError]
// after the kernel: 1 = no convergence.
extern "C" int dht_insert_launch(const void* in_hi, const void* in_lo,
                                 const void* in_used, const void* in_mp,
                                 void* slot_hi, void* slot_lo, void* used,
                                 void* max_probe, long long cap,
                                 const void* khi, const void* klo,
                                 const void* kvalid, long long n, void* slots,
                                 void* owner, void* lists, long long m,
                                 void* counters, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, insert_kernel, kInsertThreads, 0);
  if (err != cudaSuccess) return (int)err;
  int32_t* l = (int32_t*)lists;
  const long long cap_ll = cap;
  uint32_t* sh = (uint32_t*)slot_hi;
  uint32_t* sl = (uint32_t*)slot_lo;
  uint8_t* u = (uint8_t*)used;
  int32_t* own = (int32_t*)owner;
  int32_t* mp = (int32_t*)max_probe;
  int32_t* sl_out = (int32_t*)slots;
  Worklist w0{l, l + m}, w1{l + 2 * m, l + 3 * m}, wb{l + 4 * m, l + 5 * m};
  Table in{(const uint32_t*)in_hi, (const uint32_t*)in_lo,
           (const uint8_t*)in_used, (const int32_t*)in_mp};
  int32_t* ctr = (int32_t*)counters;
  void* args[] = {(void*)&in, (void*)&khi, (void*)&klo, (void*)&kvalid, (void*)&n,
                  (void*)&cap_ll, (void*)&sh, (void*)&sl, (void*)&u,
                  (void*)&own, (void*)&mp, (void*)&sl_out, (void*)&w0,
                  (void*)&w1, (void*)&wb, (void*)&ctr};
  err = cudaLaunchCooperativeKernel(
      (const void*)insert_kernel, dim3((unsigned)(per_sm * sms)),
      dim3(kInsertThreads),
      args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error for the next caller
    return (int)err;
  }
  return (int)cudaGetLastError();
}
