// Shared device helpers for the repro_torch kernels (sm_90a).
//
// Lane convention (repro_torch/core/types.py): k-mer codes are dual-lane
// (hi, lo) 32-bit words, code = hi * 2^32 + lo, packed MSB-first.  Inside a
// kernel a code is one uint64_t; every operation below gives the same bits
// as the reference's per-lane uint32 arithmetic (repro/core/kmer.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Owner hash of a canonical code: mix32(hi ^ mix32(lo ^ 0x9E3779B9)).
__device__ __forceinline__ uint32_t kmer_hash(uint32_t hi, uint32_t lo) {
  return mix32(hi ^ mix32(lo ^ 0x9E3779B9u));
}

__device__ __forceinline__ uint64_t code_mask(int k) {
  return (1ull << (2 * k)) - 1ull;  // k <= 31, so 2k <= 62
}

// Reverse complement of a 2k-bit code: complement every base (xor 0b11
// under the mask), then reverse the order of the 2-bit groups.  The
// reference reverses each 32-bit lane and shifts the 64-bit pair down by
// 64 - 2k, which is the same as the 64-bit reversal here.
__device__ __forceinline__ uint64_t reverse_complement(uint64_t code, int k) {
  uint64_t x = ~code & code_mask(k);
  x = __brevll(x);  // reverses bit order: groups reversed, pairs swapped
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

// Canonical form: the smaller of code and its RC, unsigned (= lexicographic
// (hi, lo)) order; *flip says the RC was taken.
__device__ __forceinline__ uint64_t canonical(uint64_t code, int k, bool* flip) {
  uint64_t rc = reverse_complement(code, k);
  *flip = rc < code;
  return *flip ? rc : code;
}

__device__ __forceinline__ uint8_t complement_base(uint8_t b) {
  return b < 4 ? (uint8_t)(3 - b) : b;
}

// Linear probe of an open-addressed table from hash & (cap-1).  Stops at the
// key (returns its slot), at an unused slot, or after bound + 1 steps, where
// bound = max_probe + 1; returns -1 when the key was not met.  This is the
// probe chain of repro/core/dht.py:lookup_jnp, step for step.
__device__ __forceinline__ int32_t probe(const uint32_t* __restrict__ slot_hi,
                                         const uint32_t* __restrict__ slot_lo,
                                         const uint8_t* __restrict__ used,
                                         uint32_t cap_mask, int32_t bound,
                                         uint32_t khi, uint32_t klo) {
  uint32_t a = kmer_hash(khi, klo) & cap_mask;
  for (int32_t step = 0; step <= bound; ++step) {
    if (!used[a]) return -1;
    if (slot_hi[a] == khi && slot_lo[a] == klo) return (int32_t)a;
    a = (a + 1) & cap_mask;
  }
  return -1;
}

// One probe step in one round trip: used[a], slot_hi[a] and slot_lo[a] are
// loaded together and only then compared, where `probe` reads the key
// lanes after `used` has come back.  Reading the key lanes of an unused
// slot is in bounds and changes nothing (an empty slot holds EMPTY_HI,
// which no key has).  The loads are one volatile asm statement, so they
// issue before any compare: written as `__ldg` loads, ptxas put the
// compares of used and slot_hi before the load of the walk's histogram
// row (mer_walk_kernel<true>), which then waited for their round trip
// (kernels/probe_variants.py, variant `ldg`).
enum SlotState { kSlotNext = 0, kSlotKey = 1, kSlotEmpty = 2 };

__device__ __forceinline__ int slot_match(uint32_t u, uint32_t h, uint32_t l,
                                          uint32_t khi, uint32_t klo) {
  const bool key = (u != 0) & (h == khi) & (l == klo);
  return key ? kSlotKey : (u != 0 ? kSlotNext : kSlotEmpty);
}

// used[a], slot_hi[a] and slot_lo[a], for slot_match.
__device__ __forceinline__ uint3 slot_load(const uint32_t* __restrict__ slot_hi,
                                           const uint32_t* __restrict__ slot_lo,
                                           const uint8_t* __restrict__ used,
                                           uint32_t a) {
  unsigned short u;
  uint32_t h, l;
  asm volatile(
      "ld.global.nc.u8 %0, [%3];\n\t"
      "ld.global.nc.u32 %1, [%4];\n\t"
      "ld.global.nc.u32 %2, [%5];"
      : "=h"(u), "=r"(h), "=r"(l)
      : "l"(used + a), "l"(slot_hi + a), "l"(slot_lo + a));
  return make_uint3(u, h, l);
}

// slot_match of slot a, with the 16-byte row rows[a] of a side array
// loaded beside the slot (*row; the caller keeps it where the slot holds
// the key).
__device__ __forceinline__ int slot_state_row(
    const uint32_t* __restrict__ slot_hi, const uint32_t* __restrict__ slot_lo,
    const uint8_t* __restrict__ used, const int4* __restrict__ rows,
    uint32_t a, uint32_t khi, uint32_t klo, int4* row) {
  unsigned short u;
  uint32_t h, l;
  int4 v;
  asm volatile(
      "ld.global.nc.u8 %0, [%7];\n\t"
      "ld.global.nc.u32 %1, [%8];\n\t"
      "ld.global.nc.u32 %2, [%9];\n\t"
      "ld.global.nc.v4.s32 {%3, %4, %5, %6}, [%10];"
      : "=h"(u), "=r"(h), "=r"(l), "=r"(v.x), "=r"(v.y), "=r"(v.z),
        "=r"(v.w)
      : "l"(used + a), "l"(slot_hi + a), "l"(slot_lo + a), "l"(rows + a));
  *row = v;
  return slot_match(u, h, l, khi, klo);
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return err < 0 ? "kernel loop did not converge"
                 : cudaGetErrorString((cudaError_t)err);
}
