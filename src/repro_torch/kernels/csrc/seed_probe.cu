// seed_probe: the alignment front half, seeds -> voted top-2 placements.
//
// Replaces the Pallas kernel repro/kernels/seed_probe.py:seed_probe (body
// `_kernel`), whose jnp oracle is repro/kernels/ref.py:seed_probe_ref.
// Per read: pack the S seeds at the given start columns, canonicalize,
// probe the seed index, turn each hit into a placement (contig, cstart,
// orient) from the flip parity, count for each seed the seeds that propose
// the same placement, and keep the best placement and the best one on a
// different contig (first maximum on ties, as jnp.argmax).
//
// Bound on the H100: the random gathers into the seed index.  A seed's
// probe reads `used`, `slot_hi` and `slot_lo` of a slot, and a hit four
// side arrays, each a 32-byte sector for a few useful bytes; an index of
// 2^23 slots is 159 MB, three times the L2.  The read itself is L bytes.
// Design, a group of G lanes per read (G the power of two >= S, so
// 32 / G reads a warp), one lane per seed:
//   * each lane packs its own seed from the read's row, which the block
//     staged in shared memory with 16-byte loads, four bases a 32-bit word;
//     all S probes of a read are in flight at once, not one after another;
//   * the placement stays in the lane's registers; no per-thread array is
//     indexed by seed;
//   * the vote is two __match_any_sync (the 64-bit (cstart, contig) key and
//     the orient), ANDed with the group's lanes: the support is the
//     popcount, counted only for a placed seed;
//   * best and second best are a shuffle reduction within the group on
//     (support << 5 | 31 - seed), which is jnp.argmax's first maximum.
//
// The seeds are packed with the unmasked OR of repro/core/kmer.py:
// append_base, and a seed that misses the index still takes pos/flip of
// slot 0 (the reference gathers at clip(slot, 0)): unplaced reads return the
// same orient lanes as the reference, bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxSeeds = 32;
constexpr int kMaxThreads = 256;
constexpr int kMaxSeedLen = 31;
constexpr int kMaxWords = (3 + kMaxSeedLen + 3) / 4;  // words a seed spans
// shared memory beyond the rows: up to 31 bytes before them (16 + the
// source's offset modulo 16) and the 3 a seed's last word reads past them
constexpr int kSlack = 48;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The seeds' start columns, a kernel parameter: nothing is copied to the
// device before a launch.
struct Seeds {
  int32_t col[kMaxSeeds];
};

// b0 << 6 | b1 << 4 | b2 << 2 | b3 of the four bytes of w (b0 lowest):
// four append_base steps, each base ORed in unmasked.
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return ((w & 0xFFu) << 6) | ((w >> 4) & 0xFF0u) | ((w >> 14) & 0x3FCu) |
         (w >> 24);
}

// n bytes from src to dst, where dst and src agree modulo 16.
__device__ void stage(const uint8_t* __restrict__ src, int n,
                      uint8_t* __restrict__ dst) {
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const int n16 = (n - head) / 16;
  for (int x = threadIdx.x; x < head; x += blockDim.x) dst[x] = src[x];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int x = threadIdx.x; x < n16; x += blockDim.x) d4[x] = s4[x];
  for (int x = head + 16 * n16 + threadIdx.x; x < n; x += blockDim.x)
    dst[x] = src[x];
}

__global__ void __launch_bounds__(kMaxThreads) seed_probe_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    long long R, int L, const uint32_t* __restrict__ slot_hi,
    const uint32_t* __restrict__ slot_lo, const uint8_t* __restrict__ used,
    const int32_t* __restrict__ max_probe, uint32_t cap_mask,
    const int32_t* __restrict__ s_contig, const int32_t* __restrict__ s_pos,
    const uint8_t* __restrict__ s_flip, const uint8_t* __restrict__ s_multi,
    const __grid_constant__ Seeds seeds, int S, int G, int seed_len,
    int32_t* __restrict__ out_contig, int32_t* __restrict__ out_cstart,
    uint8_t* __restrict__ out_orient) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int reads = blockDim.x / G;  // reads a block
  const long long r0 = (long long)blockIdx.x * reads;
  const int n = (int)min((long long)reads, R - r0);
  const uint8_t* src = bases + r0 * L;
  uint8_t* rows = smem + 16 + (reinterpret_cast<uintptr_t>(src) & 15);
  stage(src, n * L, rows);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x & (G - 1);  // the lane's seed
  const int gbase = lane & ~(G - 1);    // the group's first lane
  const int rr = threadIdx.x / G;
  const long long r = r0 + rr;
  const bool live = rr < n && g < S;

  int32_t cc = -1, cs = 0;
  int co = 0;
  if (live) {
    const int32_t len = lengths[r];
    const int32_t p = seeds.col[g];
    // the seed's bytes as words of shared memory: x is its first byte
    const uint8_t* at = rows + rr * L + p;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<uintptr_t>(at) & ~(uintptr_t)3);
    const int shift = 8 * (int)(reinterpret_cast<uintptr_t>(at) & 3);
    const int nw = (shift / 8 + seed_len + 3) / 4;
    uint32_t word[kMaxWords + 1];
#pragma unroll
    for (int k = 0; k <= kMaxWords; ++k) word[k] = k < nw ? w[k] : 0u;
    const int full = seed_len / 4;
    uint64_t code = 0;
    bool any_n = false;
#pragma unroll
    for (int k = 0; k < (kMaxSeedLen + 3) / 4; ++k) {
      const uint32_t c = __funnelshift_r(word[k], word[k + 1], shift);
      if (k < full) {
        any_n |= (c & 0xFCFCFCFCu) != 0;
        code = (code << 8) | pack4(c);
      } else if (k == full) {
        for (int i = 0; i < seed_len - 4 * full; ++i) {
          const uint32_t b = (c >> (8 * i)) & 0xFFu;
          any_n |= b >= 4;
          code = (code << 2) | b;
        }
      }
    }
    code &= repro::code_mask(seed_len);
    bool rflip;
    const uint64_t canon = repro::canonical(code, seed_len, &rflip);
    int32_t slot = -1;
    if (!any_n && p + seed_len <= len)
      slot = repro::probe(slot_hi, slot_lo, used, cap_mask, *max_probe + 1,
                          (uint32_t)(canon >> 32), (uint32_t)canon);
    const int32_t sl = slot < 0 ? 0 : slot;
    const bool ok = slot >= 0 && !s_multi[sl];
    const bool same = rflip == (bool)s_flip[sl];
    co = same ? 0 : 1;
    if (ok) {
      const int32_t cpos = s_pos[sl];
      cc = s_contig[sl];
      cs = same ? cpos - p : cpos - (len - p - seed_len);
    }
  }

  // the vote: lanes of the group with the same placement
  const unsigned group =
      (G == 32 ? kFull : ((1u << G) - 1u)) << gbase;
  const unsigned long long key =
      ((unsigned long long)(uint32_t)cs << 32) | (uint32_t)cc;
  const unsigned agree =
      __match_any_sync(kFull, key) & __match_any_sync(kFull, co) & group;
  const int support = cc >= 0 ? __popc(agree) : 0;

  // first maximum over the group's seeds of (support, -seed)
  const auto first_max = [&](int value) {
    int k = live ? (value << 5) | (31 - g) : -1;
    for (int d = G >> 1; d > 0; d >>= 1)
      k = max(k, __shfl_xor_sync(kFull, k, d));
    return k;
  };
  const int k1 = first_max(support);
  const int best = gbase + 31 - (k1 & 31);
  const int32_t c1 = __shfl_sync(kFull, cc, best);
  const int32_t s1 = __shfl_sync(kFull, cs, best);
  const int o1 = __shfl_sync(kFull, co, best);
  const int k2 = first_max((cc != c1 && cc >= 0) ? support : 0);
  const int best2 = gbase + 31 - (k2 & 31);
  const int32_t c2 = __shfl_sync(kFull, cc, best2);
  const int32_t s2 = __shfl_sync(kFull, cs, best2);
  const int o2 = __shfl_sync(kFull, co, best2);
  if (g == 0 && rr < n) {
    out_contig[2 * r] = c1;
    out_cstart[2 * r] = s1;
    out_orient[2 * r] = (uint8_t)o1;
    out_contig[2 * r + 1] = (k2 >> 5) > 0 ? c2 : -1;
    out_cstart[2 * r + 1] = s2;
    out_orient[2 * r + 1] = (uint8_t)o2;
  }
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
  if (S < 1 || S > kMaxSeeds || seed_len < 1 || seed_len > kMaxSeedLen ||
      L < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  // G lanes a read: the power of two >= S, larger where a warp's rows
  // would not fit the default shared memory
  int G = 1;
  while (G < S) G <<= 1;
  while (G < 32 && (size_t)(32 / G) * L + kSlack > kDefaultSmem) G <<= 1;
  int threads = kMaxThreads;
  while (threads > 32 &&
         (size_t)(threads / G) * L + kSlack > kDefaultSmem)
    threads >>= 1;
  const size_t smem = (size_t)(threads / G) * L + kSlack;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        seed_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Seeds seeds;
  for (int s = 0; s < S; ++s) seeds.col[s] = ((const int32_t*)positions)[s];
  const long long reads = threads / G;
  const unsigned blocks = (unsigned)((R + reads - 1) / reads);
  seed_probe_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, R, (int)L,
      (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
      (const uint8_t*)used, (const int32_t*)max_probe, (uint32_t)(cap - 1),
      (const int32_t*)s_contig, (const int32_t*)s_pos,
      (const uint8_t*)s_flip, (const uint8_t*)s_multi,
      seeds, S, G, seed_len, (int32_t*)out_contig,
      (int32_t*)out_cstart, (uint8_t*)out_orient);
  return (int)cudaGetLastError();
}
