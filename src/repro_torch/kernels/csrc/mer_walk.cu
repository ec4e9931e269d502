// mer_walk: the dynamic-mer ladder walk of local assembly (§II-G) and gap
// closing (§III-D), every walker's whole walk in one launch.
//
// Replaces the Pallas kernel repro/kernels/mer_walk.py:mer_walk (body
// `_kernel`), whose jnp oracle is repro/kernels/ref.py:mer_walk_ref; the
// plain version here is kernels/ref.py:mer_walk_ref.  Per step, an ACTIVE
// walker takes the canonical suffix mer of its current rung, embeds its
// contig id above the code bits, probes that rung's (contig, mer) table,
// votes over the extension histogram (the left one, reversed, when the
// canonical mer is the reverse complement), then accepts the voted base,
// moves up a rung on a fork, down on a dead end, or stops.  With a target
// (seed_len > 0) a walker whose buffer suffix becomes the target seed
// after an accepted base stops with status HIT at hit_pos = bases so far.
//
// Bound on the H100: memory latency.  Each step needs the histogram row
// of the mer the previous step's vote made, so a walker's steps are a
// chain of dependent round trips to tables of up to a few GB that do not
// fit in L2; the least time is the longest walker's steps times one
// dependent DRAM round trip (chip_smoke.py measures that round trip with
// csrc/latency_probe.cu).  The arithmetic per step (a 64-bit reversal,
// two fmix32, the vote) is small.  The design makes a step one round trip:
//   * `flip` is known from the canonical form before the probe, so a probe
//     step loads used, slot_hi and slot_lo and the histogram row the flip
//     selects (right[a] or left[a]) in one statement
//     (repro::slot_state_row), and keeps the row when the slot holds the
//     key: a key at its home slot costs one round trip, each slot further
//     on one more, and those usually hit the sectors the first brought in;
//   * each rung's max_probe + 1 is read once a block, into shared memory
//     with the rung's pointers and mask, before the step loop;
//   * the kernel writes every byte of its output row, the accepted bases
//     and then pad 4 (16-byte stores where aligned), so the caller
//     allocates it uninitialised.
// One thread per walker (kWalkersPerWarp of a warp's lanes), the whole
// walk in registers: the 31-base rolling suffix buffer is one uint64_t
// (62 bits) with its reverse complement rolled beside it, so a rung's
// canonical mer is a mask, a shift and a compare; rung, last shift,
// status, length and hit are scalars.  Unlike the TPU kernel, which
// probes every rung each step and keeps the current rung's result, only
// the current rung is probed: probes have no side effects, so the outputs
// are the same for a third of the traffic.  A walker leaves the loop when
// it stops; the reference's remaining fixed-count steps are no-ops for it.
// Each rung's table arrays come as their own pointers in a small struct
// passed by value (no stacked copy of multi-GB tables).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Lanes of a warp that walk; the others leave at once.  Eight a warp beat
// 32 and 4 on the assembly paths' walks: a warp's step waits for its
// slowest walker's loads, fewer walkers a warp wait for fewer chains.
constexpr int kWalkersPerWarp = 8;
constexpr int kMaxRungs = 3;
constexpr int kBufK = 31;
constexpr int32_t kActive = 0, kDeadend = 1, kFork = 2, kDone = 3, kHit = 4;

struct Rung {  // as the host passes it
  const uint32_t* slot_hi;
  const uint32_t* slot_lo;
  const uint8_t* used;
  const int32_t* max_probe;  // device scalar
  const int4* right;         // [cap] rows of 4 int32 counts (A, C, G, T)
  const int4* left;
  int m;                     // mer size of this rung
};

struct Ladder {
  Rung rung[kMaxRungs];
  int n;
};

struct RungState {  // a block's copy, in shared memory
  const uint32_t* slot_hi;
  const uint32_t* slot_lo;
  const uint8_t* used;
  const int4* right;
  const int4* left;
  uint64_t mask;  // code_mask(m)
  int m;
  int rc_shift;   // 2 (31 - m): the mer's reverse complement in rcbuf
  int32_t bound;  // max_probe + 1: a probe takes at most bound + 1 steps
};

// row[from, to) = 4 (pad), 16 bytes a store where the row is aligned.
__device__ __forceinline__ void fill_pad(uint8_t* row, int from, int to) {
  int j = from;
  for (; j < to && ((uintptr_t)(row + j) & 15); ++j) row[j] = 4;
  const uint4 pad = make_uint4(0x04040404u, 0x04040404u, 0x04040404u,
                               0x04040404u);
  for (; j + 16 <= to; j += 16) *(uint4*)(row + j) = pad;
  for (; j < to; ++j) row[j] = 4;
}

template <bool kTarget>
__global__ void __launch_bounds__(kThreads)
    mer_walk_kernel(const uint32_t* __restrict__ start_hi,
                    const uint32_t* __restrict__ start_lo,
                    const int32_t* __restrict__ contig,
                    const uint8_t* __restrict__ active,
                    const uint32_t* __restrict__ target_hi,
                    const uint32_t* __restrict__ target_lo, long long E,
                    const Ladder ladder, uint32_t cap_mask, int tag_bits,
                    int max_ext, int min_votes, int dominance, int seed_len,
                    uint8_t* __restrict__ out_bases,
                    int32_t* __restrict__ out_len,
                    int32_t* __restrict__ out_status,
                    uint8_t* __restrict__ out_hit,
                    int32_t* __restrict__ out_hit_pos) {
  __shared__ RungState s_rung[kMaxRungs];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRungs; ++r) {
      if (r >= ladder.n) break;
      const Rung& g = ladder.rung[r];
      s_rung[r] = RungState{g.slot_hi, g.slot_lo, g.used, g.right, g.left,
                            repro::code_mask(g.m), g.m, 2 * (kBufK - g.m),
                            __ldg(g.max_probe) + 1};
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long i =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kWalkersPerWarp +
      lane;
  if (lane >= kWalkersPerWarp || i >= E) return;
  int32_t status = active[i] ? kActive : kDone;
  int32_t len = 0;
  bool hit = false;
  int32_t hit_pos = -1;
  uint8_t* row = out_bases + i * (long long)max_ext;
  if (status == kActive) {
    uint64_t buf = ((uint64_t)start_hi[i] << 32) | start_lo[i];
    // the buffer's reverse complement, rolled beside it: a rung's mer and
    // its reverse complement are a mask and a shift away
    uint64_t rcbuf = repro::reverse_complement(buf, kBufK);
    const uint64_t tag =
        (uint64_t)((uint32_t)contig[i] & ((1u << tag_bits) - 1u));
    const uint64_t target =
        kTarget ? (((uint64_t)target_hi[i] << 32) | target_lo[i]) : 0ull;
    const uint64_t seed_mask = kTarget ? repro::code_mask(seed_len) : 0ull;
    const int n = ladder.n;
    int rung = n / 2;
    int last_shift = 0;
    for (int step = 0; step < max_ext; ++step) {
      const RungState& r = s_rung[rung];
      const uint64_t fwd = buf & r.mask;
      const uint64_t rc = rcbuf >> r.rc_shift;
      const bool flip = rc < fwd;  // repro::canonical, from the rolled rc
      const uint64_t canon = flip ? rc : fwd;
      const uint64_t key = canon | (tag << (2 * r.m));
      const uint32_t khi = (uint32_t)(key >> 32), klo = (uint32_t)key;
      // the probe, the histogram row the flip selects loaded with each
      // slot's key lanes; kept where the slot holds the key
      const int4* hist = flip ? r.left : r.right;
      const int32_t bound = r.bound;
      uint32_t a = repro::kmer_hash(khi, klo) & cap_mask;
      int4 v = make_int4(0, 0, 0, 0);
      for (int32_t p = 0; p <= bound; ++p) {
        int4 h4;
        const int s = repro::slot_state_row(r.slot_hi, r.slot_lo, r.used,
                                            hist, a, khi, klo, &h4);
        v = s == repro::kSlotKey ? h4 : v;
        if (s != repro::kSlotNext) break;
        a = (a + 1) & cap_mask;
      }
      // walk frame of an RC mer: the left counts, reversed
      const int h[4] = {flip ? v.w : v.x, flip ? v.z : v.y,
                        flip ? v.y : v.z, flip ? v.x : v.w};
      // the vote: first maximal base, uncontested or dominant
      int c1 = h[0], best = 0, viable = 0;
      long long total = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (h[b] > c1) { c1 = h[b]; best = b; }
        viable += h[b] >= min_votes;
        total += h[b];
      }
      const long long second = total - c1;
      const bool accept =
          (viable == 1 && c1 >= min_votes) ||
          (viable > 1 &&
           (long long)c1 >= (long long)dominance * (second > 1 ? second : 1) &&
           c1 >= min_votes + 1);
      if (accept) {
        buf = ((buf << 2) | (uint64_t)best) & repro::code_mask(kBufK);
        rcbuf = (rcbuf >> 2) | ((uint64_t)(3 - best) << (2 * kBufK - 2));
        row[len++] = (uint8_t)best;
        last_shift = 0;
        if (kTarget && (buf & seed_mask) == target) {
          hit = true;
          hit_pos = len;
          status = kHit;
          break;
        }
      } else if (viable == 0) {  // dead end: down a rung, or stop
        if (rung == 0 || last_shift == 1) { status = kDeadend; break; }
        --rung;
        last_shift = -1;
      } else {  // fork: up a rung, or stop
        if (rung == n - 1 || last_shift == -1) { status = kFork; break; }
        ++rung;
        last_shift = 1;
      }
    }
  }
  fill_pad(row, len, max_ext);
  out_len[i] = len;
  out_status[i] = status;
  out_hit[i] = hit;
  out_hit_pos[i] = hit_pos;
}

}  // namespace

// rung_ptrs: host array of 6 pointers per rung (slot_hi, slot_lo, used,
// max_probe, right_hist, left_hist); mer_sizes: host array of n_rungs.
// The kernel writes every byte of out_bases [E, max_ext]; target_hi/lo are
// read only when seed_len > 0 (null otherwise).
extern "C" int mer_walk_launch(const void* start_hi, const void* start_lo,
                               const void* contig, const void* active,
                               const void* target_hi, const void* target_lo,
                               long long E, const void* const* rung_ptrs,
                               const int* mer_sizes, int n_rungs,
                               long long cap, int tag_bits, int max_ext,
                               int min_votes, int dominance, int seed_len,
                               void* out_bases, void* out_len,
                               void* out_status, void* out_hit,
                               void* out_hit_pos, void* stream) {
  if (n_rungs < 1 || n_rungs > kMaxRungs || tag_bits < 0 || tag_bits > 16 ||
      max_ext < 1 || seed_len < 0 || seed_len > kBufK)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  Ladder ladder{};
  ladder.n = n_rungs;
  for (int r = 0; r < n_rungs; ++r) {
    const void* const* p = rung_ptrs + 6 * r;
    ladder.rung[r] = Rung{(const uint32_t*)p[0], (const uint32_t*)p[1],
                          (const uint8_t*)p[2],  (const int32_t*)p[3],
                          (const int4*)p[4],     (const int4*)p[5],
                          mer_sizes[r]};
  }
  const long long per_block = (long long)kWarps * kWalkersPerWarp;
  const long long blocks = (E + per_block - 1) / per_block;
  const uint32_t cap_mask = (uint32_t)(cap - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (seed_len > 0) {
    mer_walk_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)start_hi, (const uint32_t*)start_lo,
        (const int32_t*)contig, (const uint8_t*)active,
        (const uint32_t*)target_hi, (const uint32_t*)target_lo, E, ladder,
        cap_mask, tag_bits, max_ext, min_votes, dominance, seed_len,
        (uint8_t*)out_bases, (int32_t*)out_len, (int32_t*)out_status,
        (uint8_t*)out_hit, (int32_t*)out_hit_pos);
  } else {
    mer_walk_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)start_hi, (const uint32_t*)start_lo,
        (const int32_t*)contig, (const uint8_t*)active,
        (const uint32_t*)target_hi, (const uint32_t*)target_lo, E, ladder,
        cap_mask, tag_bits, max_ext, min_votes, dominance, seed_len,
        (uint8_t*)out_bases, (int32_t*)out_len, (int32_t*)out_status,
        (uint8_t*)out_hit, (int32_t*)out_hit_pos);
  }
  return (int)cudaGetLastError();
}
