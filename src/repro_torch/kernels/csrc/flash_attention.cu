// flash_attention: causal or non-causal GQA attention with an online
// softmax, the LM substrate's prefill hot spot.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention (body `_kernel`); the plain version here is
// kernels/ref.py:flash_attention_ref.  For q [B, H, S, D] and k, v
// [B, KH, S, D] (H % KH == 0; query head h reads KV head h / (H / KH), the
// reference's jnp.repeat, indexed here and never materialised), per query
// row i of each (b, h):
//
//   s_j   = (q_i . k_j) * scale       fp32; scale = 1/sqrt(D) by default
//   s_j   = -1e30 where causal and j > i (the reference's constant)
//   m, l, acc: the online softmax over key tiles, all fp32
//   out_i = acc / max(l, 1e-30), cast to q's dtype (fp32 or bf16).
//
// Any S >= 1: keys past S in the last tile are masked like causal ones and
// query rows past S are computed from zeros and never stored.  Key 0 is
// live for every row and sits in the first tile, so m is a real score
// after that tile and every masked key weighs exp(-1e30 - m) = 0, as in
// the reference.  Causal query tiles run longest first, and a key tile
// that lies wholly above a tile's last row is never loaded.
//
// Bound on the H100: operations.  4 D flops a (query, key) pair, S (S +
// 1) / 2 pairs a head when causal (S^2 otherwise).  At llama3.2-3b's call
// (B 2, H 24, S 4096, D 128; 206.2 GFLOP) that is 0.21 ms for bf16 on the
// tensor cores (989 TFLOP/s) and 1.25 ms for fp32 through the 3xTF32 split
// below (495 / 3 = 165 TFLOP/s; the fp32 pipes outside the tensor cores,
// 67 TFLOP/s, would take 3.08 ms); the bytes (q, k, v read once, out
// written once) take 0.04-0.08 ms.  Two kernels, one a dtype:
//
// bf16 -- wgmma fed by TMA (the FlashAttention-3 shape on sm_90a).  One
// CTA of 288 threads per (b * h, 128-row query tile): two consumer
// warpgroups of 64 rows each and one producer warp.  The producer's lane 0
// loads the Q tile once and streams K and V tiles of 128 keys (64 at
// D = 256) through a 2-stage ring, all by TMA (cp.async.bulk.tensor, 3-D
// tensor maps over [B * heads, S, D] encoded on the host every call) into
// 128-byte-swizzled shared memory; mbarriers report each copy (full) and
// each release by the 8 consumer warps (empty).  A consumer warpgroup runs
// S = Q K^T as wgmma.m64nNk16 from shared memory (both K-major, fp32
// accumulators), the online softmax in registers (exp2 of log2-scaled
// scores; row max and sum over the 4 lanes of a row), converts P to bf16
// in registers, where the accumulator layout of S is already the A
// fragment layout of P V, and runs O += P V as wgmma with A from registers
// and V as an MN-major B operand (the descriptor transposes it).  D pads
// to a whole number of 64-column (128-byte) swizzle atoms: 16, 32 and 64
// to 64; 112 and 128 to 128, 256 as it is.  A box of 64 columns past the
// tensor's D is zero-filled by TMA, so the padded columns add zeros to
// S, give zero columns of O that are never stored, and cost 1/7 more MMA
// work at D = 112.
//
// fp32 -- 3xTF32 on mma.sync.m16n8k8 (tf32.cuh).  wgmma's TF32 form needs
// both operands K-major, which V is not, so this kernel runs the warp-level
// MMA.  One CTA per (b * h, query tile of 16 rows a warp: 8 warps and 128
// rows, 4 and 64 at D = 256); q is pre-scaled and staged once in shared
// memory (longest causal tiles first, as in bf16), times scale log2 e so
// the softmax runs on exp2 as in bf16; K and V tiles
// of 64 keys (32 at D = 256) stream through a 2-stage cp.async ring.
// Shared rows are padded to D + 4 floats, so every fragment load below is
// free of bank conflicts.  Both products split each operand into hi and
// lo TF32 parts and accumulate lo.hi, hi.lo, hi.hi; P goes from the S
// accumulators straight into A fragments of P V by reading k slot t as key
// 2t and slot t + 4 as key 2t + 1 (V's rows are loaded in that order).
// The tensor core's accumulator rounds toward zero, so neither product
// runs a long HMMA chain into one accumulator: S keeps its small terms
// apart from a_hi b_hi (one HMMA a k-step into each score), and each key
// tile's P V is added to O, rescaled by alpha, with an fp32 FMA.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using repro::EncodeTiled;
using repro::encode_tiled;
using repro::fence_regs;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_desc;
using repro::smem_u32;
using repro::tensor_map;
using repro::tma_load_3d;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_wait_all;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // softmax in base 2: exp2
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------- fp32

template <int D>
struct F32Tile {
  static constexpr int kWarps = D > 128 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;      // query rows a CTA
  static constexpr int kBN = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int kStride = D + 4;          // padded row, in floats
  // O's column blocks go through P V in this many parts, so that a part's
  // fresh accumulator and O fit the registers (2 at D = 256)
  static constexpr int kPVParts = D > 128 ? 2 : 1;
  static constexpr int kQ = kRows * kStride;
  static constexpr int kKV = kBN * kStride;      // one of K or V, one stage
  static constexpr size_t bytes = sizeof(float) * (size_t)(kQ + 4 * kKV);
};

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int KH, int S, int causal, float scale_log2) {
  using Cfg = F32Tile<D>;
  using repro::FragA;
  constexpr int KS = Cfg::kStride;
  constexpr int BN = Cfg::kBN;
  constexpr int NT = D / 8;  // 8-column blocks of O, 8-deep k-steps of S
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][KS]
  float* ks = qs + Cfg::kQ;                     // [2][BN][KS]
  float* vs = ks + 2 * Cfg::kKV;                // [2][BN][KS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * Cfg::kRows;  // longest first
  const int b = bh / H;
  const int h = bh - b * H;
  const long long kv_base = ((long long)b * KH + h / (H / KH)) * S * D;
  const float* qg = q + (long long)bh * S * D;

  auto load_kv = [&](int tile, int st) {
    const int n0 = tile * BN;
    float* kd = ks + st * Cfg::kKV;
    float* vd = vs + st * Cfg::kKV;
    for (int i = tid; i < BN * (D / 4); i += Cfg::kThreads) {
      const int j = i / (D / 4);
      const int c = (i - j * (D / 4)) * 4;
      const bool ok = n0 + j < S;  // keys past S: zeros
      const long long off = kv_base + (long long)(ok ? n0 + j : 0) * D + c;
      repro::cp_async16(kd + j * KS + c, k + off, ok);
      repro::cp_async16(vd + j * KS + c, v + off, ok);
    }
    repro::cp_async_commit();
  };

  const int kv_end = causal ? min(S, m0 + Cfg::kRows) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_kv(0, 0);
  for (int i = tid; i < Cfg::kRows * (D / 4); i += Cfg::kThreads) {
    const int r = i / (D / 4);
    const int c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < S) {
      x = *reinterpret_cast<const float4*>(qg + (long long)(m0 + r) * D + c);
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
    }
    *reinterpret_cast<float4*>(qs + r * KS + c) = x;
  }

  const int r0 = m0 + 16 * warp;  // this warp's first row
  const float* qw = qs + 16 * warp * KS;
  float o[NT][4];
  float m[2] = {kNeg, kNeg};  // rows r0 + g and r0 + g + 8
  float l[2] = {0.f, 0.f};    // this lane's share of the row sums
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1, st ^ 1);  // overlaps this tile's products
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K, V (and Q) are visible
    const int n0 = tile * BN;
    if (r0 < S && !(causal && n0 > r0 + 15)) {
      const float* kt = ks + st * Cfg::kKV;
      const float* vt = vs + st * Cfg::kKV;

      // S = (q scale log2 e) K^T, 3xTF32, the small terms and a_hi b_hi in
      // separate accumulators: the big one takes one HMMA a k-step
      float s[BN / 8][4], small[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = small[j][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < NT; ++kk) {
        const float* qa = qw + g * KS + kk * 8 + t4;
        const FragA a(qa[0], qa[8 * KS], qa[4], qa[8 * KS + 4]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float* kb = kt + (j * 8 + g) * KS + kk * 8 + t4;
          repro::mma_3xtf32(small[j], s[j], a, kb[0], kb[4]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];

      // mask, then the online softmax; lane holds keys 2 t4, 2 t4 + 1 of
      // each 8-key block for rows r0 + g (e < 2) and r0 + g + 8
      const bool edge = (causal && n0 + BN - 1 > r0) || n0 + BN > S;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = n0 + j * 8 + 2 * t4 + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (key >= S || (causal && key > row)) s[j][e] = kNeg;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }

      // O = alpha O + P V: the tile's P V in a fresh accumulator (3xTF32;
      // k slot t4 is key 2 t4, slot t4 + 4 key 2 t4 + 1), PARTS column
      // blocks of O at a time, then added to O in fp32
      constexpr int PARTS = Cfg::kPVParts, NP = NT / PARTS;
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        float pv[NP][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const FragA a(s[j][0], s[j][2], s[j][1], s[j][3]);
          const float* vb = vt + (j * 8 + 2 * t4) * KS + part * NP * 8 + g;
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            if (j == 0)
              repro::mma_3xtf32<true>(pv[n], a, vb[n * 8], vb[KS + n * 8]);
            else
              repro::mma_3xtf32(pv[n], a, vb[n * 8], vb[KS + n * 8]);
          }
        }
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[part * NP + n][e] =
                fmaf(o[part * NP + n][e], alpha[e >> 1], pv[n][e]);
      }
    }
    __syncthreads();  // the stage is consumed before the next load
  }

  if (r0 >= S) return;  // no barrier follows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row < S) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* orow = out + ((long long)bh * S + row) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- bf16

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A, B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A, B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers (bf16 pairs), B
// MN-major in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]; A in registers (bf16 pairs), B
// MN-major in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// DP: D padded to whole 64-column swizzle atoms (64, 128, 256)
template <int DP>
struct Bf16Tile {
  static constexpr int kRows = 128;             // two warpgroups of 64
  static constexpr int kBN = DP > 128 ? 64 : 128;
  static constexpr int kBlocks = DP / 64;       // 128-byte column blocks
  static constexpr int kQBlock = kRows * 128;   // bytes of one Q block
  static constexpr int kQBytes = kBlocks * kQBlock;
  static constexpr int kKVBlock = kBN * 128;
  static constexpr int kKVBytes = kBlocks * kKVBlock;  // K or V, one stage
  static constexpr int kThreads = 288;
  // + 1024: the tiles start at the next 1024-byte boundary (swizzle atom)
  static constexpr size_t bytes = 1024 + kQBytes + 4 * (size_t)kKVBytes;
};

template <int DP>
__global__ void __launch_bounds__(288, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out, int H, int KH, int S,
                  int D, int causal, float scale_log2) {
  using Cfg = Bf16Tile<DP>;
  constexpr int BN = Cfg::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];  // q, full[2], empty[2]
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Cfg::kQBytes;    // [2][kKVBytes]
  const uint32_t sv = sk + 2 * Cfg::kKVBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);   // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[3]);  // + 8 st

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * Cfg::kRows;  // longest first
  const int b = bh / H;
  const int zkv = b * KH + (bh - b * H) / (H / KH);
  const int kv_end = causal ? min(S, m0 + Cfg::kRows) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp; lane 0 issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, Cfg::kQBytes);
      for (int c = 0; c < Cfg::kBlocks; ++c)
        tma_load_3d(sq + c * Cfg::kQBlock, &tq, bar_q, 64 * c, m0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t & 1;
        if (t >= 2) mbar_wait(bar_empty + 8 * st, ((t >> 1) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * Cfg::kKVBytes);
        for (int c = 0; c < Cfg::kBlocks; ++c) {
          const uint32_t off = st * Cfg::kKVBytes + c * Cfg::kKVBlock;
          tma_load_3d(sk + off, &tk, bar_full + 8 * st, 64 * c, t * BN, zkv);
          tma_load_3d(sv + off, &tv, bar_full + 8 * st, 64 * c, t * BN, zkv);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows row_lo .. row_lo + 63; this lane's rows are
  // ra (accumulator entries i % 4 < 2) and ra + 8, its columns
  // 8 (i / 4) + 2 (lane % 4) + i % 2
  const int wg = warp >> 2;
  const int row_lo = m0 + 64 * wg;
  const int ra = row_lo + 16 * (warp & 3) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    mbar_wait(bar_full + 8 * st, (t >> 1) & 1);
    const int n0 = t * BN;
    if (row_lo < S && !(causal && n0 > row_lo + 63)) {
      // S = Q K^T on the tensor cores
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t k_off = (kk & 3) * 32;  // 16 bf16 a k-step
        const uint64_t da = smem_desc(
            sq + (kk >> 2) * Cfg::kQBlock + wg * 64 * 128 + k_off, 0, 1024);
        const uint64_t db = smem_desc(
            sk + st * Cfg::kKVBytes + (kk >> 2) * Cfg::kKVBlock + k_off, 0,
            1024);
        wgmma_ss<BN>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // mask, then the online softmax in log2 units
      const bool edge = (causal && n0 + BN - 1 > row_lo) || n0 + BN > S;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int key = n0 + 8 * (i >> 2) + c2 + (i & 1);
          const int row = ra + 8 * ((i >> 1) & 1);
          if (key >= S || (causal && key > row)) x = kNeg;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = exp2f(s[8 * kk + e] - m[(e >> 1) & 1]);
          l[(e >> 1) & 1] += p[e];
        }
        // the accumulator blocks 2 kk, 2 kk + 1 of S are the A fragment
        // of keys 16 kk .. 16 kk + 15: (ra, k), (ra + 8, k), (ra, k + 8),
        // (ra + 8, k + 8) for k = c2, c2 + 1
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V; V MN-major: 8-key groups 1024 bytes apart, 64-column
      // blocks kKVBlock apart, 16 keys a k-step
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = smem_desc(
            sv + st * Cfg::kKVBytes + kk * 16 * 128, Cfg::kKVBlock, 1024);
        wgmma_rs<DP>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done
  }

  if (row_lo >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = ra + 8 * r;
    if (row < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = out + ((long long)bh * S + row) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + c2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
              o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int KH, int S, int causal, float scale,
               cudaStream_t stream) {
  using Cfg = F32Tile<D>;
  auto kern = flash_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H),
                  (unsigned)((S + Cfg::kRows - 1) / Cfg::kRows));
  kern<<<grid, Cfg::kThreads, Cfg::bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, KH,
      S, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_f32_d(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int KH, int S, int D, int causal, float scale,
                 cudaStream_t st) {
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, out, B, H, KH, S, causal, scale, st);
    case 32: return launch_f32<32>(q, k, v, out, B, H, KH, S, causal, scale, st);
    case 64: return launch_f32<64>(q, k, v, out, B, H, KH, S, causal, scale, st);
    case 112: return launch_f32<112>(q, k, v, out, B, H, KH, S, causal, scale, st);
    case 128: return launch_f32<128>(q, k, v, out, B, H, KH, S, causal, scale, st);
    case 256: return launch_f32<256>(q, k, v, out, B, H, KH, S, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// [Z, S, D] bf16 as a 3-D tensor map with boxes of 64 columns x rows x 1,
// 128-byte swizzle; past D and past S the box is zero-filled
bool bf16_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int Z,
              int S, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)S * (cuuint64_t)D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return tensor_map(map, enc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims,
                    strides, box);
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KH, int S, int D, int causal, float scale,
                cudaStream_t stream) {
  using Cfg = Bf16Tile<DP>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!bf16_map(&tq, enc, q, B * H, S, D, Cfg::kRows) ||
      !bf16_map(&tk, enc, k, B * KH, S, D, Cfg::kBN) ||
      !bf16_map(&tv, enc, v, B * KH, S, D, Cfg::kBN))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bf16_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H),
                  (unsigned)((S + Cfg::kRows - 1) / Cfg::kRows));
  kern<<<grid, Cfg::kThreads, Cfg::bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, H, KH, S, D, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q, k, v
// and out are contiguous and 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KH, int S, int D, int causal,
                                      float scale, int dtype, void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7FFFFFFFLL || (S + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32_d(q, k, v, out, B, H, KH, S, D, causal, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: case 32: case 64:
      return launch_bf16<64>(q, k, v, out, B, H, KH, S, D, causal, scale, st);
    case 112: case 128:
      return launch_bf16<128>(q, k, v, out, B, H, KH, S, D, causal, scale, st);
    case 256:
      return launch_bf16<256>(q, k, v, out, B, H, KH, S, D, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
