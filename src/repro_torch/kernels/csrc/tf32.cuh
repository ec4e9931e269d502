// fp32-accurate products on the tensor cores (sm_80+ mma.sync, TF32), and
// the cp.async copies that feed them; shared by flash_attention's fp32
// kernel and ssd_scan.
//
// 3xTF32: a TF32 operand keeps 10 of fp32's 23 mantissa bits, so one TF32
// product is good to about 5e-4, too coarse for the port's fp32
// tolerances (1e-5 for flash_attention, 2e-4 for ssd_scan at |C . B| ~
// 30).  Each fp32 operand x is split as
//   hi = x rounded to TF32, half away from zero (cvt.rna.tf32.f32)
//   lo = x - hi (exact in fp32), which the tensor core reads truncated to
//        TF32 (it ignores the low 13 bits of an operand)
// and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, each
// product exact in the tensor core's fp32 accumulator; a_lo b_lo and lo's
// truncation (each under 2^-21 relative) are dropped.  This is CUTLASS's
// OpMultiplyAddFastF32.  tests/test_torch_tf32_split.py holds the split
// to float64 on the CPU.
//
// Cost: sm_90a has no SASS instruction for cvt.rna.tf32.f32; ptxas emits
// four (add 0x1000, mask, and an inf/NaN test and select).  hi is computed
// here as (bits + 0x1000) & ~0x1FFF, the same value for every finite x in
// two instructions; for an inf or NaN x, lo = x - hi is NaN, so the
// products are NaN as they are with cvt.rna.  With lo left unrounded, a
// value splits in 3 instructions instead of 9: the split, not the HMMAs,
// was what the first version of both kernels waited on (PERF.md §6).
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A [16 x 8] row-major   a0 (g, t)    a1 (g + 8, t)   a2 (g, t + 4)
//                          a3 (g + 8, t + 4)
//   B [8 x 8]  col-major   b0 (t, g)    b1 (t + 4, g)
//   C [16 x 8]             c0 (g, 2t)   c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                          c3 (g + 8, 2t + 1)
// The order of the k index is free as long as A and B agree on it, so a
// C fragment becomes the A fragment of the next product without
// shuffles: read k slot t as column 2t and k slot t + 4 as column 2t + 1
// (a = {c0, c2, c1, c3}), and load B's rows in the same order.
#pragma once

#include <cstdint>

namespace repro {

struct Tf32x2 {
  uint32_t hi, lo;
};

// x rounded to TF32, half away from zero: cvt.rna.tf32.f32 for finite x
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// d += a b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (4 fp32 values) split into its hi and lo TF32 parts.
struct FragA {
  uint32_t hi[4], lo[4];
  FragA() = default;
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    const float v[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Tf32x2 s = split_tf32(v[i]);
      hi[i] = s.hi;
      lo[i] = s.lo;
    }
  }
};

// d = a b on one m16n8k8 TF32 tile (a fresh accumulator)
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a b in 3xTF32, for b = (b0, b1) given as fp32; d = a b when Fresh.
//
// The tensor core adds each product into its fp32 accumulator rounding
// toward zero, so a long chain of HMMAs into one accumulator drifts: the
// first fp32 flash kernel, which accumulated O over all key tiles (1536
// HMMAs at S = 4096), missed its 1e-5 tolerance at llama3.2-3b's call
// whichever way the operands were split (PERF.md §6).  Callers keep
// the chains short: a few k-steps into a Fresh accumulator, added to the
// running sum with an ordinary (round-to-nearest) fp32 add, or the small
// terms apart from a_hi b_hi (the overload below).
template <bool Fresh = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           float b0, float b1) {
  const Tf32x2 s0 = split_tf32(b0), s1 = split_tf32(b1);
  const uint32_t bhi[2] = {s0.hi, s1.hi}, blo[2] = {s0.lo, s1.lo};
  if constexpr (Fresh) mma_tf32_fresh(d, a.lo, bhi);
  else mma_tf32(d, a.lo, bhi);
  mma_tf32(d, a.hi, blo);
  mma_tf32(d, a.hi, bhi);
}

// The same three products into two accumulators, the small terms into
// `small` and a_hi b_hi into `big` (summed by the caller): two dependency
// chains instead of one, for loops with few independent accumulators.
__device__ __forceinline__ void mma_3xtf32(float (&small)[4], float (&big)[4],
                                           const FragA& a, float b0,
                                           float b1) {
  const Tf32x2 s0 = split_tf32(b0), s1 = split_tf32(b1);
  const uint32_t bhi[2] = {s0.hi, s1.hi}, blo[2] = {s0.lo, s1.lo};
  mma_tf32(small, a.lo, bhi);
  mma_tf32(small, a.hi, blo);
  mma_tf32(big, a.hi, bhi);
}

// cp.async of 16 bytes (zero-filled when !valid: src-size 0) and of 4
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace repro
