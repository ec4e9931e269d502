// kmer_extract: every k-mer lane of a dense [R, L] base matrix in one pass.
//
// Replaces the Pallas kernel repro/kernels/kmer_extract.py:kmer_extract
// (body `_kernel`).  Output lanes, each [R, L] (the last k-1 columns are
// padding: codes 0, extensions 4, flags false), as kernels/ref.py:
// kmer_extract_ref gives them:
//   hi, lo, hash  canonical dual-lane code and its owner hash (uint32)
//   left, right   canonicalized extension bases (uint8, 4 = absent)
//   flip, valid   canonical == RC; window inside the read with no N (bool)
//
// Bound on the H100: memory.  Each window reads ~1 base and writes 16 bytes
// (three 4-byte lanes, four 1-byte lanes); the arithmetic (<= 31 shift/or
// steps, a 64-bit reversal, two fmix32) is far below the integer rate.
// Design: one thread per window over the flattened [R, L] array, so short
// reads waste no threads; a block stages the bases its windows span
// (blockDim + k + 1 bytes, one coalesced read) in shared memory and each
// thread packs its <= 31 bases from there directly, with no serial roll
// between neighbours.  All seven lanes are written coalesced.
//
// Packing ORs each base in unmasked, as repro/core/kmer.py:append_base does:
// an N (code 4) sets bit 2 of the low lane.  Such windows are invalid, but
// their lanes are compared bit for bit all the same.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void kmer_extract_kernel(const uint8_t* __restrict__ bases,
                                    const int32_t* __restrict__ lengths,
                                    long long R, long long L, int k,
                                    uint32_t* __restrict__ out_hi,
                                    uint32_t* __restrict__ out_lo,
                                    uint32_t* __restrict__ out_hash,
                                    uint8_t* __restrict__ out_left,
                                    uint8_t* __restrict__ out_right,
                                    uint8_t* __restrict__ out_flip,
                                    uint8_t* __restrict__ out_valid) {
  extern __shared__ uint8_t tile[];  // bases[g0 - 1, g0 + blockDim + k)
  const long long total = R * L;
  const long long g0 = (long long)blockIdx.x * blockDim.x;
  const int span = blockDim.x + k + 1;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    long long src = g0 - 1 + j;
    tile[j] = (src >= 0 && src < total) ? bases[src] : (uint8_t)4;
  }
  __syncthreads();
  const long long g = g0 + threadIdx.x;
  if (g >= total) return;
  const long long r = g / L;
  const long long pos = g - r * L;
  const long long W = L - k + 1;
  if (pos >= W) {
    out_hi[g] = 0u;
    out_lo[g] = 0u;
    out_hash[g] = 0u;
    out_left[g] = 4;
    out_right[g] = 4;
    out_flip[g] = 0;
    out_valid[g] = 0;
    return;
  }
  const uint8_t* w = tile + threadIdx.x + 1;  // w[0] = bases[r, pos]
  const uint64_t mask = repro::code_mask(k);
  uint64_t code = 0;
  bool any_n = false;
  for (int i = 0; i < k; ++i) {
    const uint8_t b = w[i];
    any_n |= b >= 4;
    code = ((code << 2) | b) & mask;  // unmasked base, as append_base
  }
  bool flip;
  const uint64_t c = repro::canonical(code, k, &flip);
  const uint32_t hi = (uint32_t)(c >> 32);
  const uint32_t lo = (uint32_t)c;
  const long long len = lengths[r];
  const uint8_t left_f = pos > 0 ? w[-1] : (uint8_t)4;
  const uint8_t right_f = (pos + k < L && pos + k < len) ? w[k] : (uint8_t)4;
  out_hi[g] = hi;
  out_lo[g] = lo;
  out_hash[g] = repro::kmer_hash(hi, lo);
  out_left[g] = flip ? repro::complement_base(right_f) : left_f;
  out_right[g] = flip ? repro::complement_base(left_f) : right_f;
  out_flip[g] = flip;
  out_valid[g] = !any_n && pos + k <= len;
}

}  // namespace

extern "C" int kmer_extract_launch(const void* bases, const void* lengths,
                                   long long R, long long L, int k,
                                   void* hi, void* lo, void* hash, void* left,
                                   void* right, void* flip, void* valid,
                                   void* stream) {
  const long long total = R * L;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = kThreads + k + 1;
  kmer_extract_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, R, L, k,
      (uint32_t*)hi, (uint32_t*)lo, (uint32_t*)hash, (uint8_t*)left,
      (uint8_t*)right, (uint8_t*)flip, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
