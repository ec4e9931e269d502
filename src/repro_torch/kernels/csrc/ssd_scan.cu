// ssd_scan: the Mamba-2 scalar-decay SSD scan, chunked, with an fp32
// [P, N] state carried from chunk to chunk (zamba2's sequence mixer).
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (body
// `_kernel`); the plain version here is kernels/ref.py:ssd_scan_ref.  For
// x [B, S, H, P], log-decays a [B, S, H] and b, c [B, S, H, N] (fp32,
// contiguous), per (b, h) and chunk of T rows, with cum = cumsum(a) over
// the chunk:
//
//   G[t, s] = (C[t] . B[s]) exp(cum[t] - cum[s])   for s <= t, else 0
//   y[t]    = sum_s G[t, s] x[s] + exp(cum[t]) (C[t] . state)
//   state   = exp(cum[T-1]) state + sum_s exp(cum[T-1] - cum[s]) x[s] B[s]^T
//
// cum is summed and differenced in fp64 and rounded to fp32 before exp: a
// chunk's decays sum to about -100 at zamba2-7b's widths, and in fp32 the
// exponent cum[t] - cum[s] of two such sums carries their rounding (about
// 1e-5, depending on the order of the sum) into every G entry, which at
// |C . B| ~ 30 is 3e-4 of y; in fp64 the kernel, its plain version and the
// CPU agree whatever order each sums in.
//
// The causal mask is applied before exp, never as inf * 0: the Pallas
// kernel and the reference's ssd_chunked form exp(cum[t] - cum[s]) above
// the diagonal too, which overflows to inf (and inf * 0 to NaN) once a
// chunk's decays sum below about -88.7 (ROADMAP.md Queue 3).  Here the
// exponent of every term that is kept is <= 0 for decays <= 0.
//
// Bound on the H100: bytes.  x, b, c read once and y written once (943 MB
// at zamba2-7b's call: B 2, S 4096, H 112, P = N = 64, T 128) take 0.28
// ms at 3.35 TB/s.  The operations -- C B^T and G x over the T (T + 1) / 2
// causal pairs of a chunk (2 N and 2 P flops a pair), and in all but one
// chunk C . state and the state update (2 T P N flops each; the state is
// zero in the first chunk, and only y is output), 29.7 GFLOP -- take 0.18
// ms on the tensor cores through the 3xTF32 split (495 / 3 = 165 TFLOP/s;
// 0.44 ms on the fp32 pipes outside them).
//
// Design: one CTA of 8 warps per (b, h) walks the S / T chunks in order;
// the TPU kernel's sequential grid axis becomes that loop, so no block
// carries anything to another, and only x, a, b, c in and y out pass
// through device memory.  Shared memory (224 KB, one CTA an SM) holds two
// stages of the chunk's C, B, x ([T][68] floats each; a row of 68 = 4 mod
// 32 floats makes every fragment load below free of bank conflicts) and
// a, the [P][68] state, fp64 cum, exp(cum[t]) and the tail weights.  While
// chunk c computes, chunk c + 1 is copied into the other stage by cp.async.
// All four products run on the tensor cores in 3xTF32 (tf32.cuh:
// mma.sync.m16n8k8, each operand split into hi and lo TF32 parts; a
// single TF32 product would miss the 2e-4 tolerance at |C . B| ~ 30).  Per
// chunk:
//   1. warp 0 takes cum by an fp64 prefix sum (4 rows a lane, then a
//      shuffle scan), and exp(cum[t]), exp(cum[T-1] - cum[s]);
//   2. each warp owns a 16-row band of G and y (bands pair up (0, 7),
//      (1, 6), (2, 5), (3, 4) on the four SM sub-partitions, warps w and
//      w + 4, so each pair does the same work).  The band's rows of C are
//      split once into A fragments; y starts as exp(cum[t]) (C state^T);
//   3. then G x, two 8-column blocks of G at a time and only those at or
//      left of the diagonal (2 band + 2 of 16: the tiles wholly above it
//      are skipped, which halves the two largest products): a block of
//      C B^T, its decay masked before exp, and the block, as it stands in
//      the accumulator registers, as the A fragment of G x (k slot t is
//      column 2t, slot t + 4 column 2t + 1, and x's rows are loaded in that
//      order), so no shuffle and no shared copy of G is needed.  This loop
//      runs a runtime count of iterations with no branch inside its
//      unrolled body, and C B^T keeps 8 independent accumulators (two
//      blocks, k-steps by parity, small and big terms apart) so its
//      HMMAs overlap; y is stored;
//   4. after a barrier (every warp has read the old state), the state
//      update: warp w owns state rows 16 (w % 4) .. + 15 and columns
//      32 (w / 4) .. + 31, (x diag(tail))^T B over the chunk's rows.
// T <= 128, P <= 64 and N <= 64 are runtime sizes under those fixed
// maxima: the unused rows and columns stay zero in shared memory, so they
// add nothing.  224 CTAs at zamba2-7b's call, 1.7 waves on the 132 SMs.
#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kT = 128;  // rows of a chunk, at most
constexpr int kP = 64;   // head width, at most
constexpr int kN = 64;   // state width, at most
constexpr int kThreads = 256;
constexpr int kRS = 68;  // padded row stride of C, B, x and the state
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kRS >= kP && kRS >= kN && kRS % 32 == 4, "row stride");

// Shared memory of one CTA, offsets in floats.
struct Smem {
  static constexpr int kTile = kT * kRS;          // one of C, B, x
  static constexpr int kStage = 3 * kTile + kT;   // C, B, x, then a
  static constexpr int st = 2 * kStage;           // [kP][kRS]: state[p][n]
  static constexpr int din = st + kP * kRS;       // [kT] exp(cum[t])
  static constexpr int tail = din + kT;           // [kT] exp(cum[T-1] - cum[s])
  static constexpr int cum = tail + kT;           // [kT] doubles
  static constexpr int end = cum + 2 * kT;
  static constexpr size_t bytes = sizeof(float) * (size_t)end;
};
static_assert(Smem::cum % 2 == 0, "cum is 8-byte aligned");
static_assert(Smem::bytes <= 232448, "one CTA an SM");

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ y, int S, int H, int P, int N, int T,
                int vec) {
  using repro::FragA;
  extern __shared__ double smem_d[];
  float* smem = reinterpret_cast<float*>(smem_d);
  float* st = smem + Smem::st;
  float* din = smem + Smem::din;
  float* tail = smem + Smem::tail;
  double* cum = reinterpret_cast<double*>(smem + Smem::cum);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x - bi * H;

  // chunk ch's C, B, x and a into stage sb (rows of 16-byte copies where
  // the widths and pointers allow, else 4-byte ones)
  auto load_chunk = [&](int ch, int sb) {
    float* cs = smem + sb * Smem::kStage;
    float* bs = cs + Smem::kTile;
    float* xs = bs + Smem::kTile;
    float* as = xs + Smem::kTile;
    const long long row0 = (long long)bi * S + (long long)ch * T;
    if (vec) {
      const int p4 = P / 4, n4 = N / 4;
      for (int i = tid; i < T * p4; i += kThreads) {
        const int t = i / p4;
        const int q = (i - t * p4) * 4;
        repro::cp_async16(xs + t * kRS + q, x + ((row0 + t) * H + h) * P + q,
                          true);
      }
      for (int i = tid; i < T * n4; i += kThreads) {
        const int t = i / n4;
        const int q = (i - t * n4) * 4;
        const long long gi = ((row0 + t) * H + h) * N + q;
        repro::cp_async16(bs + t * kRS + q, b + gi, true);
        repro::cp_async16(cs + t * kRS + q, c + gi, true);
      }
    } else {
      for (int i = tid; i < T * P; i += kThreads) {
        const int t = i / P;
        const int q = i - t * P;
        repro::cp_async4(xs + t * kRS + q, x + ((row0 + t) * H + h) * P + q);
      }
      for (int i = tid; i < T * N; i += kThreads) {
        const int t = i / N;
        const int q = i - t * N;
        const long long gi = ((row0 + t) * H + h) * N + q;
        repro::cp_async4(bs + t * kRS + q, b + gi);
        repro::cp_async4(cs + t * kRS + q, c + gi);
      }
    }
    for (int t = tid; t < T; t += kThreads)
      repro::cp_async4(as + t, a + (row0 + t) * H + h);
    repro::cp_async_commit();
  };

  // zeros: the state starts at zero, and padding rows and columns of both
  // stages stay zero (the copies only write rows < T, columns < P or N)
  for (int i = tid; i < Smem::end; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int band = warp < 4 ? warp : 11 - warp;  // 16-row band of G and y
  const int t0 = 16 * band;
  const int n_blk = 2 * band + 2;  // 8-column blocks at or left of the diagonal
  const int n_chunks = S / T;
  load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int sb = ch & 1;
    repro::cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1 is done with
                      // its stage and the state is updated
    if (ch + 1 < n_chunks) load_chunk(ch + 1, sb ^ 1);
    const float* cs = smem + sb * Smem::kStage;
    const float* bs = cs + Smem::kTile;
    const float* xs = bs + Smem::kTile;
    const float* as = xs + Smem::kTile;

    if (warp == 0) {  // 1. cum = cumsum(a) over the chunk in fp64
      double v[4];
      double run = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run += (double)as[lane * 4 + i];  // zero past T
        v[i] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      const double off = incl - run;
#pragma unroll
      for (int i = 0; i < 4; ++i) cum[lane * 4 + i] = off + v[i];
      __syncwarp();
      const double last = cum[T - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = lane * 4 + i;
        din[t] = t < T ? expf((float)cum[t]) : 0.f;
        tail[t] = t < T ? expf((float)(last - cum[t])) : 0.f;
      }
    }
    __syncthreads();

    // the band's rows of C as A fragments, split once for C state^T and
    // C B^T
    FragA cf[kN / 8];
#pragma unroll
    for (int kk = 0; kk < kN / 8; ++kk) {
      const float* ca = cs + (t0 + g) * kRS + kk * 8 + t4;
      cf[kk] = FragA(ca[0], ca[8 * kRS], ca[4], ca[8 * kRS + 4]);
    }

    // 2. y = exp(cum[t]) (C . state) ...
    float yacc[kP / 8][4];
#pragma unroll
    for (int n = 0; n < kP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
    if (ch > 0) {  // the state is zero before the first chunk
#pragma unroll
      for (int kk = 0; kk < kN / 8; ++kk) {
#pragma unroll
        for (int n = 0; n < kP / 8; ++n) {
          const float* sp = st + (8 * n + g) * kRS + kk * 8 + t4;
          repro::mma_3xtf32(yacc[n], cf[kk], sp[0], sp[4]);
        }
      }
      const float d0 = din[t0 + g], d1 = din[t0 + g + 8];
#pragma unroll
      for (int n = 0; n < kP / 8; ++n) {
        yacc[n][0] *= d0;
        yacc[n][1] *= d0;
        yacc[n][2] *= d1;
        yacc[n][3] *= d1;
      }
    }

    // ... + G x, two 8-column blocks of the band's G at a time: each block
    // G = mask(C B^T) exp(cum[t] - cum[s]) (its k-steps split by parity and
    // into small and big terms: 8 accumulator chains), then the block as
    // the A fragment of G x (k slot t4 is column 2 t4, slot t4 + 4 column
    // 2 t4 + 1, and x's rows are loaded in that order).  Only the blocks
    // at or left of the diagonal: the rest of G is zero.
    const double cum_r[2] = {cum[t0 + g], cum[t0 + g + 8]};
#pragma unroll 1
    for (int j0 = 0; j0 < n_blk; j0 += 2) {
      float gsm[2][2][4], gbg[2][2][4];  // [block][k parity][entry]
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) gsm[jj][q][e] = gbg[jj][q][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 8; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* bb = bs + (8 * (j0 + jj) + g) * kRS + kk * 8 + t4;
          repro::mma_3xtf32(gsm[jj][kk & 1], gbg[jj][kk & 1], cf[kk], bb[0],
                            bb[4]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g + 8 * (e >> 1);
          const int s = 8 * (j0 + jj) + 2 * t4 + (e & 1);
          const float cb = (gsm[jj][0][e] + gsm[jj][1][e]) +
                           (gbg[jj][0][e] + gbg[jj][1][e]);
          gv[e] = s <= t ? cb * expf((float)(cum_r[e >> 1] - cum[s])) : 0.f;
        }
        const FragA fa(gv[0], gv[2], gv[1], gv[3]);
        const float* xb = xs + (8 * (j0 + jj) + 2 * t4) * kRS + g;
#pragma unroll
        for (int n = 0; n < kP / 8; ++n)
          repro::mma_3xtf32(yacc[n], fa, xb[8 * n], xb[kRS + 8 * n]);
      }
    }
    {
      const long long row0 = (long long)bi * S + (long long)ch * T;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + g + 8 * r;
        if (t < T) {
          float* yr = y + ((row0 + t) * H + h) * P;
#pragma unroll
          for (int n = 0; n < kP / 8; ++n) {
            const int p = 8 * n + 2 * t4;
            if (p < P) yr[p] = yacc[n][2 * r];
            if (p + 1 < P) yr[p + 1] = yacc[n][2 * r + 1];
          }
        }
      }
    }
    __syncthreads();  // every warp has read the old state

    // 3. state = exp(cum[T-1]) state + sum_s tail[s] x[s] B[s]^T; k slot
    // t4 is row s = 8 kk + 2 t4 of the chunk, slot t4 + 4 is s + 1; the
    // k-steps split by parity (8 accumulator chains)
    {
      const int p0 = 16 * (warp & 3);
      const int n0 = 32 * (warp >> 2);
      float u[2][4][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[q][n][e] = 0.f;
#pragma unroll 2
      for (int k2 = 0; k2 < kT / 8; k2 += 2) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s0 = 8 * (k2 + q) + 2 * t4;
          const float w0 = tail[s0], w1 = tail[s0 + 1];
          const float* xa = xs + s0 * kRS + p0 + g;
          const FragA fa(xa[0] * w0, xa[8] * w0, xa[kRS] * w1,
                         xa[kRS + 8] * w1);
          const float* bb = bs + s0 * kRS + n0 + g;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            repro::mma_3xtf32(u[q][n], fa, bb[8 * n], bb[kRS + 8 * n]);
        }
      }
      const float total = din[T - 1];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* sp = st + (p0 + g + 8 * (e >> 1)) * kRS + n0 + 8 * n +
                      2 * t4 + (e & 1);
          *sp = total * *sp + (u[0][n][e] + u[1][n][e]);
        }
    }
  }
}

}  // namespace

// x, y [B, S, H, P]; a [B, S, H]; b, c [B, S, H, N]; fp32, contiguous.
// T is the chunk (S % T == 0); T <= 128, P <= 64, N <= 64.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, void* y, int B, int S, int H,
                               int P, int N, int T, void* stream) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || P > kP || N < 1 || N > kN ||
      T < 1 || T > kT || S % T != 0 || (long long)B * H > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const int vec = P % 4 == 0 && N % 4 == 0 &&
                  (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<<<(unsigned)(B * H), kThreads, Smem::bytes,
                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)c,
      (float*)y, S, H, P, N, T, vec);
  return (int)cudaGetLastError();
}
