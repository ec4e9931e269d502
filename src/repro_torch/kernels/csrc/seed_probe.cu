// seed_probe: the alignment front half, seeds -> voted top-2 placements.
//
// Replaces the Pallas kernel repro/kernels/seed_probe.py:seed_probe (body
// `_kernel`), whose jnp oracle is repro/kernels/ref.py:seed_probe_ref.
// Per read: pack the S seeds at the given start columns, canonicalize,
// probe the seed index, turn each hit into a placement (contig, cstart,
// orient) from the flip parity, count for each seed the seeds that propose
// the same placement (O(S^2) vote), and keep the best placement and the
// best one on a different contig (first maximum on ties, as jnp.argmax).
//
// Bound on the H100: latency of the dependent probe loads into the seed
// index (random gathers, ~9 bytes a probe step plus 10 bytes of side arrays
// a hit); the read itself is L bytes.  Design: one thread per read; the S
// <= kMaxSeeds placements and the vote stay in registers / local memory,
// and only the six [R, 2] outputs are written.
//
// The seeds are packed with the unmasked OR of repro/core/kmer.py:
// append_base, and a seed that misses the index still takes pos/flip of
// slot 0 (the reference gathers at clip(slot, 0)): unplaced reads return the
// same orient lanes as the reference, bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSeeds = 32;

__global__ void seed_probe_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    long long R, long long L, const uint32_t* __restrict__ slot_hi,
    const uint32_t* __restrict__ slot_lo, const uint8_t* __restrict__ used,
    const int32_t* __restrict__ max_probe, uint32_t cap_mask,
    const int32_t* __restrict__ s_contig, const int32_t* __restrict__ s_pos,
    const uint8_t* __restrict__ s_flip, const uint8_t* __restrict__ s_multi,
    const int32_t* __restrict__ positions, int S, int seed_len,
    int32_t* __restrict__ out_contig, int32_t* __restrict__ out_cstart,
    uint8_t* __restrict__ out_orient) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint8_t* row = bases + r * L;
  const int32_t len = lengths[r];
  const int32_t bound = *max_probe + 1;
  const uint64_t mask = repro::code_mask(seed_len);
  int32_t cc[kMaxSeeds], cs[kMaxSeeds];
  uint8_t co[kMaxSeeds];
  for (int s = 0; s < S; ++s) {
    const int32_t p = positions[s];
    uint64_t code = 0;
    bool any_n = false;
    for (int i = 0; i < seed_len; ++i) {
      const uint8_t b = row[p + i];
      any_n |= b >= 4;
      code = ((code << 2) | b) & mask;
    }
    bool rflip;
    const uint64_t c = repro::canonical(code, seed_len, &rflip);
    int32_t slot = -1;
    if (!any_n && p + seed_len <= len)
      slot = repro::probe(slot_hi, slot_lo, used, cap_mask, bound,
                          (uint32_t)(c >> 32), (uint32_t)c);
    const int32_t sl = slot < 0 ? 0 : slot;
    const bool ok = slot >= 0 && !s_multi[sl];
    const int32_t cpos = s_pos[sl];
    const bool same = rflip == (bool)s_flip[sl];
    cc[s] = ok ? s_contig[sl] : -1;
    cs[s] = ok ? (same ? cpos - p : cpos - (len - p - seed_len)) : 0;
    co[s] = same ? 0 : 1;
  }
  int best = 0;
  int32_t best_support = -1;
  int32_t support[kMaxSeeds];
  for (int s = 0; s < S; ++s) {
    int32_t n = 0;
    if (cc[s] >= 0) {
      for (int t = 0; t < S; ++t)
        n += cc[s] == cc[t] && cs[s] == cs[t] && co[s] == co[t];
    }
    support[s] = n;
    if (n > best_support) {
      best_support = n;
      best = s;
    }
  }
  const int32_t c1 = cc[best];
  int best2 = 0;
  int32_t best2_support = -1;
  for (int s = 0; s < S; ++s) {
    const int32_t n = (cc[s] != c1 && cc[s] >= 0) ? support[s] : 0;
    if (n > best2_support) {
      best2_support = n;
      best2 = s;
    }
  }
  out_contig[2 * r] = c1;
  out_cstart[2 * r] = cs[best];
  out_orient[2 * r] = co[best];
  out_contig[2 * r + 1] = best2_support > 0 ? cc[best2] : -1;
  out_cstart[2 * r + 1] = cs[best2];
  out_orient[2 * r + 1] = co[best2];
}

}  // namespace

extern "C" int seed_probe_max_seeds() { return kMaxSeeds; }

extern "C" int seed_probe_launch(
    const void* bases, const void* lengths, long long R, long long L,
    const void* slot_hi, const void* slot_lo, const void* used,
    const void* max_probe, long long cap, const void* s_contig,
    const void* s_pos, const void* s_flip, const void* s_multi,
    const void* positions, int S, int seed_len, void* out_contig,
    void* out_cstart, void* out_orient, void* stream) {
  if (R == 0) return 0;
  const unsigned blocks = (unsigned)((R + kThreads - 1) / kThreads);
  seed_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, R, L,
      (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
      (const uint8_t*)used, (const int32_t*)max_probe, (uint32_t)(cap - 1),
      (const int32_t*)s_contig, (const int32_t*)s_pos,
      (const uint8_t*)s_flip, (const uint8_t*)s_multi,
      (const int32_t*)positions, S, seed_len, (int32_t*)out_contig,
      (int32_t*)out_cstart, (uint8_t*)out_orient);
  return (int)cudaGetLastError();
}
