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
// Bound on the H100: memory latency.  Each step is a dependent chain of
// hash probes (9 bytes a slot) and one 16-byte histogram row, in tables
// of up to a few GB that do not fit in L2; the arithmetic per step (a
// 64-bit reversal, two fmix32, the vote) is small.
// Design: one thread per walker, the whole walk in registers: the 31-base
// rolling suffix buffer is one uint64_t (62 bits), rung, last shift,
// status, length and hit are scalars.  Unlike the TPU kernel, which probes
// every rung each step and keeps the current rung's result, only the
// current rung is probed: probes have no side effects, so the outputs are
// the same for a third of the traffic.  A walker leaves the loop when it
// stops; the reference's remaining fixed-count steps are no-ops for it.
// Each rung's table arrays come as their own pointers in a small struct
// passed by value (no stacked copy of multi-GB tables).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRungs = 3;
constexpr int kBufK = 31;
constexpr int32_t kActive = 0, kDeadend = 1, kFork = 2, kDone = 3, kHit = 4;

struct Rung {
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

template <bool kTarget>
__global__ void mer_walk_kernel(const uint32_t* __restrict__ start_hi,
                                const uint32_t* __restrict__ start_lo,
                                const int32_t* __restrict__ contig,
                                const uint8_t* __restrict__ active,
                                const uint32_t* __restrict__ target_hi,
                                const uint32_t* __restrict__ target_lo,
                                long long E, const Ladder ladder,
                                uint32_t cap_mask, int tag_bits, int max_ext,
                                int min_votes, int dominance, int seed_len,
                                uint8_t* __restrict__ out_bases,
                                int32_t* __restrict__ out_len,
                                int32_t* __restrict__ out_status,
                                uint8_t* __restrict__ out_hit,
                                int32_t* __restrict__ out_hit_pos) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  int32_t status = active[i] ? kActive : kDone;
  int32_t len = 0;
  bool hit = false;
  int32_t hit_pos = -1;
  if (status == kActive) {
    uint64_t buf = ((uint64_t)start_hi[i] << 32) | start_lo[i];
    const uint64_t tag =
        (uint64_t)((uint32_t)contig[i] & ((1u << tag_bits) - 1u));
    const uint64_t target =
        kTarget ? (((uint64_t)target_hi[i] << 32) | target_lo[i]) : 0ull;
    const uint64_t seed_mask = kTarget ? repro::code_mask(seed_len) : 0ull;
    uint8_t* row = out_bases + i * (long long)max_ext;
    const int n = ladder.n;
    int rung = n / 2;
    int last_shift = 0;
    for (int step = 0; step < max_ext; ++step) {
      const Rung& r = ladder.rung[rung];
      bool flip;
      const uint64_t canon =
          repro::canonical(buf & repro::code_mask(r.m), r.m, &flip);
      const uint64_t key = canon | (tag << (2 * r.m));
      const int32_t slot =
          repro::probe(r.slot_hi, r.slot_lo, r.used, cap_mask,
                       *r.max_probe + 1, (uint32_t)(key >> 32),
                       (uint32_t)key);
      int h[4] = {0, 0, 0, 0};
      if (slot >= 0) {
        if (flip) {  // walk frame of an RC mer: the left counts, reversed
          const int4 v = r.left[slot];
          h[0] = v.w; h[1] = v.z; h[2] = v.y; h[3] = v.x;
        } else {
          const int4 v = r.right[slot];
          h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
        }
      }
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
  out_len[i] = len;
  out_status[i] = status;
  out_hit[i] = hit;
  out_hit_pos[i] = hit_pos;
}

}  // namespace

// rung_ptrs: host array of 6 pointers per rung (slot_hi, slot_lo, used,
// max_probe, right_hist, left_hist); mer_sizes: host array of n_rungs.
// out_bases must hold 4 (pad) everywhere on entry; the kernel writes only
// the accepted bases.
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
  const long long blocks = (E + kThreads - 1) / kThreads;
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
