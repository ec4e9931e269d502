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
// Bound on the H100: operations.  Per (b, h) and chunk, C B^T and G x over
// the T (T + 1) / 2 causal pairs (2 N and 2 P flops a pair); in all but one
// chunk, C . state and the state update (2 T P N flops each; the state is
// zero in the first chunk, and only y is output): at zamba2-7b's call (B 2,
// S 4096, H 112, P = N = 64, T 128) 29.7 GFLOP on the fp32 pipes outside
// the tensor cores (67 TFLOP/s), 0.443 ms, against 0.28 ms for the bytes
// (x, b, c read once and y written once, 943 MB).
//
// Design: one CTA of 256 threads per (b, h) walks the S / T chunks in
// order; the TPU kernel's sequential grid axis becomes that loop, so no
// block carries anything to another.  P whole per CTA, so G is formed once
// per (b, chunk, h).  Shared memory (185 KB, one CTA an SM) holds the
// chunk's C, B and x ([T][64 + 1] floats each, rows padded by one float so
// that the 16 threads of a half-warp read 16 banks), G ([T][T + 1]), the
// [P][N + 1] state, cum, exp(cum) and the tail weights.  Per chunk:
//   1. the chunk's x, B, C and a are loaded (coalesced rows of P or N
//      floats); warp 0 takes cum by an fp64 prefix sum (4 rows a lane,
//      then a shuffle scan), and exp(cum[t]), exp(cum[T-1] - cum[s]);
//   2. G: each thread owns rows ty + 16 i and columns tx + 16 j (i, j < 8)
//      of the 128 x 128 tile, an outer product over n in registers;
//   3. y: rows ty + 16 i and columns tx + 16 j (j < 4): G x over s plus
//      C . state over n, scaled by exp(cum[t]); stored to y;
//   4. the state update: rows p = ty + 16 i, columns n = tx + 16 j (i, j
//      < 4), a sum over s of tail-weighted x[s] B[s]^T, each thread
//      rewriting its own 16 state entries after every thread has read the
//      old state in step 3.
// Plain FMAs on the SIMT pipes (no mma / wgmma, no TMA or cp.async
// pipelining yet).  T <= 128, P <= 64 and N <= 64 are runtime sizes under
// those fixed maxima: the unused rows and columns stay zero in shared
// memory, so they add nothing.  224 CTAs at zamba2-7b's call, 1.7 waves on
// the 132 SMs.
#include "common.cuh"

namespace {

constexpr int kT = 128;  // rows of a chunk, at most
constexpr int kP = 64;   // head width, at most
constexpr int kN = 64;   // state width, at most
constexpr int kThreads = 256;
constexpr int kRS = kN + 1;  // padded row stride of C, B and the state
constexpr int kXS = kP + 1;  // padded row stride of x
constexpr int kGS = kT + 1;  // padded row stride of G
constexpr unsigned kFull = 0xFFFFFFFFu;

// Shared memory of one CTA: cum, [kT] doubles, then the floats (offsets
// in floats).
struct Smem {
  static constexpr int c = 2 * kT;           // [kT][kRS]
  static constexpr int b = c + kT * kRS;     // [kT][kRS]
  static constexpr int x = b + kT * kRS;     // [kT][kXS]
  static constexpr int g = x + kT * kXS;     // [kT][kGS]
  static constexpr int st = g + kT * kGS;    // [kP][kRS]: state[p][n]
  static constexpr int din = st + kP * kRS;  // [kT] exp(cum[t])
  static constexpr int tail = din + kT;      // [kT] exp(cum[T-1] - cum[s])
  static constexpr int end = tail + kT;
  static constexpr size_t bytes = sizeof(float) * (size_t)end;
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ y, int S, int H, int P, int N, int T) {
  extern __shared__ double smem_d[];
  double* cum = smem_d;
  float* smem = reinterpret_cast<float*>(smem_d);
  float* cs = smem + Smem::c;
  float* bs = smem + Smem::b;
  float* xs = smem + Smem::x;
  float* gs = smem + Smem::g;
  float* st = smem + Smem::st;
  float* din = smem + Smem::din;
  float* tail = smem + Smem::tail;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x - bi * H;

  // the state starts at zero; padding rows and columns stay zero
  for (int i = tid; i < Smem::end; i += kThreads) smem[i] = 0.f;

  const int n_chunks = S / T;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long row0 = (long long)bi * S + (long long)ch * T;
    __syncthreads();  // the last chunk's reads are done (and smem zeroed)
    for (int idx = tid; idx < T * P; idx += kThreads) {
      const int t = idx / P;
      const int p = idx - t * P;
      xs[t * kXS + p] = x[((row0 + t) * H + h) * P + p];
    }
    for (int idx = tid; idx < T * N; idx += kThreads) {
      const int t = idx / N;
      const int n = idx - t * N;
      const long long gi = ((row0 + t) * H + h) * N + n;
      bs[t * kRS + n] = b[gi];
      cs[t * kRS + n] = c[gi];
    }
    if (tid < 32) {  // cum = cumsum(a) over the chunk in fp64, 4 rows a lane
      double v[4];
      double run = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tid * 4 + i;
        run += t < T ? (double)a[(row0 + t) * H + h] : 0.0;
        v[i] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(kFull, incl, o);
        if (tid >= o) incl += up;
      }
      const double off = incl - run;
#pragma unroll
      for (int i = 0; i < 4; ++i) cum[tid * 4 + i] = off + v[i];
      __syncwarp();
      const double last = cum[T - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tid * 4 + i;
        din[t] = t < T ? expf((float)cum[t]) : 0.f;
        tail[t] = t < T ? expf((float)(last - cum[t])) : 0.f;
      }
    }
    __syncthreads();

    // 2. G = mask(C B^T) * exp(cum[t] - cum[s]), the mask before exp
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * kRS + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * kRS + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          gs[t * kGS + s] = (s <= t && t < T)
              ? acc[i][j] * expf((float)(cum[t] - cum[s])) : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. y = G x + exp(cum[t]) (C . state)
    {
      float acc[8][4], acs[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acs[i][j] = 0.f;
#pragma unroll 2
      for (int s = 0; s < T; ++s) {
        float gv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) gv[i] = gs[(ty + 16 * i) * kGS + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[s * kXS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
      if (ch > 0) {  // the state is zero before the first chunk
#pragma unroll 2
        for (int n = 0; n < N; ++n) {
          float cv[8], sv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * kRS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = st[(tx + 16 * j) * kRS + n];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acs[i][j] = fmaf(cv[i], sv[j], acs[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        if (t >= T) continue;
        float* yr = y + ((row0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yr[p] = acc[i][j] + din[t] * acs[i][j];
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // 4. state = exp(cum[T-1]) state + sum_s tail[s] x[s] B[s]^T
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int s = 0; s < T; ++s) {
        const float w = tail[s];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[s * kXS + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float total = din[T - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = st + (ty + 16 * i) * kRS + tx + 16 * j;
          *sp = total * *sp + acc[i][j];
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
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<<<(unsigned)(B * H), kThreads, Smem::bytes,
                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)c,
      (float*)y, S, H, P, N, T);
  return (int)cudaGetLastError();
}
