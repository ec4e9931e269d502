// ssd_scan_wide: the SSD scan of ssd_scan.cu for heads wider than its
// 64-wide state (P or N in 65..256): the mLSTM of xlstm-125m, whose matrix
// memory is a scan at P = N = d / H = 192 (models/ssm.py:mlstm_block).
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (body
// `_kernel`) at those widths; kernels/ops.py:ssd_scan sends P, N <= 64 to
// ssd_scan.cu and wider heads here.  The plain version is
// kernels/ref.py:ssd_scan_ref.  It computes what ssd_scan.cu computes, with
// the same numerics: per (b, h) and chunk of T rows, cum = cumsum(a) in
// fp64 and rounded to fp32 before exp, the causal mask applied before exp,
//
//   G[t, s] = (C[t] . B[s]) exp(cum[t] - cum[s])   for s <= t, else 0
//   y[t]    = sum_s G[t, s] x[s] + exp(cum[t]) (C[t] . state)
//   state   = exp(cum[T-1]) state + sum_s exp(cum[T-1] - cum[s]) x[s] B[s]^T
//
// and every product on the tensor cores in 3xTF32 (tf32.cuh), each chain
// of HMMAs kept as short as ssd_scan.cu keeps it: C B^T and C state^T a
// 64-wide N tile at a time into fresh accumulators, summed by fp32 adds.
//
// Why not ssd_scan.cu's layout: it keeps the whole [P][N] state and two
// stages of C, B and x in one CTA's shared memory and walks the chunks of
// a (b, h) in order.  At P = N = 192 the state alone is ~150 KB and one
// stage of C, B, x at T = 128 ~300 KB, over the 227 KB a CTA can have; and
// at the prefill's B = 2, H = 4 that is 8 CTAs on 132 SMs.  Here the scan
// is split in three launches, each in 64-wide tiles of P and N:
//   1. chunk_state, per (b, h, chunk < nc - 1, P tile, N tile): the
//      chunk's own hand-on, upd = sum_s exp(cum[T-1] - cum[s]) x[s] B[s]^T,
//      into `states` [B, H, nc, P, N] (fp32), and its total decay
//      exp(cum[T-1]) into `totals` [B, H, nc];
//   2. carry, one thread per state entry: in chunk order, states[ch] <- s,
//      s = total[ch] s + upd[ch], so states[ch] becomes the state entering
//      chunk ch (the only pass that walks the chunks in order, 4 bytes a
//      chunk a thread);
//   3. output, per (b, h, chunk, 64-wide P tile): G of the chunk (over
//      every N tile) into shared memory, masked and decayed, then
//      y = exp(cum[t]) C state^T + G x.  C B^T is recomputed for each of
//      the ceil(P / 64) P tiles: the simple choice, a third of phase 3's
//      products at P = 192 (ROADMAP.md Queue 2).
// 768 CTAs in phase 3 at the prefill's call (B 2, S 4096, H 4, P = N =
// 192, T 128), 49,152 at B 1, S 524,288; `states` is 37.7 MB and 2.4 GB.
//
// Bound on the H100 at the prefill's call: operations.  C B^T and G x over
// the T (T + 1) / 2 causal pairs of a chunk (2 N and 2 P flops a pair),
// C . state and the state update (2 T P N flops each) in all but the first
// chunk: 6.30 GFLOP, 0.038 ms at 165 TFLOP/s (3xTF32); x, b, c, y and a,
// 100.8 MB, take 0.030 ms at 3.35 TB/s.  The carried states add 3 x 37.7
// MB of traffic that the bound does not count.
//
// T <= 128 and P, N <= 256 are runtime sizes: tile rows past T and
// columns past P or N are zero-filled in shared memory, so they add
// nothing.
#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kT = 128;         // rows of a chunk, at most
constexpr int kW = 64;          // width of a P or N tile
constexpr int kMaxWidth = 256;  // P, N at most (ops.py: _SSD_WIDE_MAX)
constexpr int kThreads = 256;
// row strides in floats: C, B, the state and phase 1's x 4 mod 32, phase
// 3's x 8 mod 32, G 4 mod 32, so that every fragment load below is free of
// bank conflicts
constexpr int kRS = 68;
constexpr int kXS = 72;
constexpr int kGS = 132;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kRS % 32 == 4 && kGS % 32 == 4 && kXS % 32 == 8, "strides");

// Shared memory of a phase 1 CTA, offsets in floats.
struct Smem1 {
  static constexpr int xs = 0;                  // [kT][kRS] x[s][p]
  static constexpr int bs = xs + kT * kRS;      // [kT][kRS] B[s][n]
  static constexpr int as = bs + kT * kRS;      // [kT] a
  static constexpr int tail = as + kT;          // [kT] exp(cum[T-1] - cum[s])
  static constexpr int cum = tail + kT;         // [kT] doubles
  static constexpr int end = cum + 2 * kT;
  static constexpr size_t bytes = sizeof(float) * (size_t)end;
};

// Shared memory of a phase 3 CTA, offsets in floats.
struct Smem3 {
  static constexpr int cs = 0;                  // [kT][kRS] C[t][n], an N tile
  static constexpr int bs = cs + kT * kRS;      // [kT][kRS] B[s][n], an N tile
  static constexpr int sts = bs + kT * kRS;     // [kW][kRS] state[p][n]
  static constexpr int xs = sts + kW * kRS;     // [kT][kXS] x[s][p]
  static constexpr int gs = xs + kT * kXS;      // [kT][kGS] G[t][s]
  static constexpr int as = gs + kT * kGS;      // [kT] a
  static constexpr int din = as + kT;           // [kT] exp(cum[t])
  static constexpr int cum = din + kT;          // [kT] doubles
  static constexpr int end = cum + 2 * kT;
  static constexpr size_t bytes = sizeof(float) * (size_t)end;
};
static_assert(Smem1::cum % 2 == 0 && Smem3::cum % 2 == 0, "cum alignment");
static_assert(Smem1::bs % 4 == 0 && Smem3::bs % 4 == 0 &&
                  Smem3::sts % 4 == 0 && Smem3::xs % 4 == 0,
              "16-byte tiles");
static_assert(Smem3::bytes <= 232448, "one CTA an SM");

// Rows 0..rows-1, columns col0..col0+kW-1 of a row-major matrix (row r at
// base + r * pitch, W columns) into a [rows][stride] tile of shared memory;
// rows >= nrows and columns >= W are zero-filled.  16-byte copies when
// `vec` (W % 4 == 0 and base 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void load_tile(float* dst, int stride, int rows,
                                          const float* __restrict__ base,
                                          long long pitch, int nrows,
                                          int col0, int W, int vec) {
  if (vec) {
    constexpr int kQ = kW / 4;
    for (int i = threadIdx.x; i < rows * kQ; i += kThreads) {
      const int r = i / kQ;
      const int q = (i - r * kQ) * 4;
      const bool ok = r < nrows && col0 + q < W;
      repro::cp_async16(dst + r * stride + q,
                        ok ? base + r * pitch + col0 + q : base, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kW; i += kThreads) {
      const int r = i / kW;
      const int q = i - r * kW;
      if (r < nrows && col0 + q < W)
        repro::cp_async4(dst + r * stride + q, base + r * pitch + col0 + q);
      else
        dst[r * stride + q] = 0.f;
    }
  }
}

// a[t] of the chunk's T rows into as[0..kT), zero past T
__device__ __forceinline__ void load_decays(float* as,
                                            const float* __restrict__ a,
                                            long long row0, int H, int h,
                                            int T) {
  for (int t = threadIdx.x; t < kT; t += kThreads) {
    if (t < T) repro::cp_async4(as + t, a + (row0 + t) * H + h);
    else as[t] = 0.f;
  }
}

// cum = cumsum(a) over the chunk in fp64, by one warp: 4 rows a lane, then
// a shuffle scan (ssd_scan.cu's step 1)
__device__ __forceinline__ void chunk_cumsum(const float* as, double* cum,
                                             int lane) {
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += (double)as[lane * 4 + i];
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
}

// Phase 1.  grid (nc - 1, P tiles x N tiles, B H).
__global__ void __launch_bounds__(kThreads)
ssd_wide_chunk_state_kernel(const float* __restrict__ x,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ states,
                            float* __restrict__ totals, int S, int H, int P,
                            int N, int T, int nc, int n_ntiles, int vec) {
  using repro::FragA;
  extern __shared__ double smem_d[];
  float* smem = reinterpret_cast<float*>(smem_d);
  float* xs = smem + Smem1::xs;
  float* bs = smem + Smem1::bs;
  float* as = smem + Smem1::as;
  float* tail = smem + Smem1::tail;
  double* cum = reinterpret_cast<double*>(smem + Smem1::cum);

  const int ch = blockIdx.x;
  const int pt = blockIdx.y / n_ntiles;
  const int nt = blockIdx.y - pt * n_ntiles;
  const int bh = blockIdx.z;
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const long long row0 = (long long)bi * S + (long long)ch * T;

  load_decays(as, a, row0, H, h, T);
  load_tile(xs, kRS, kT, x + (row0 * H + h) * P, (long long)H * P, T,
            pt * kW, P, vec);
  load_tile(bs, kRS, kT, b + (row0 * H + h) * N, (long long)H * N, T,
            nt * kW, N, vec);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    chunk_cumsum(as, cum, lane);
    const double last = cum[T - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      tail[t] = t < T ? expf((float)(last - cum[t])) : 0.f;
    }
    if (blockIdx.y == 0 && lane == 0)
      totals[(long long)bh * nc + ch] = expf((float)last);
  }
  __syncthreads();

  // upd[p][n] = sum_s tail[s] x[s][p] B[s][n]: warp w owns rows
  // 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31 of the 64 x 64 tile;
  // k slot t4 is row s = 8 k + 2 t4 of the chunk, slot t4 + 4 is s + 1; the
  // k-steps split by parity (8 accumulator chains), as ssd_scan.cu's
  // step 3
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
  float* out = states + ((long long)bh * nc + ch) * P * N;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pt * kW + p0 + g + 8 * (e >> 1);
      const int nn = nt * kW + n0 + 8 * n + 2 * t4 + (e & 1);
      if (p < P && nn < N)
        out[(long long)p * N + nn] = u[0][n][e] + u[1][n][e];
    }
}

// Phase 2.  grid (ceil(P N / 256), B H); one thread a state entry.
__global__ void __launch_bounds__(256)
ssd_wide_carry_kernel(float* __restrict__ states,
                      const float* __restrict__ totals, int nc,
                      long long PN) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.y;
  float* st = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  float s = 0.f;
  int ch = 0;
  // the hand-ons of 8 chunks loaded before the 8 dependent updates
  for (; ch + 8 <= nc - 1; ch += 8) {
    float u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = st[(long long)(ch + i) * PN];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      st[(long long)(ch + i) * PN] = s;
      s = fmaf(tot[ch + i], s, u[i]);
    }
  }
  for (; ch < nc - 1; ++ch) {
    const float u = st[(long long)ch * PN];
    st[(long long)ch * PN] = s;
    s = fmaf(tot[ch], s, u);
  }
  st[(long long)(nc - 1) * PN] = s;  // the last chunk hands nothing on
}

// Phase 3.  grid (nc, P tiles, B H).
__global__ void __launch_bounds__(kThreads, 1)
ssd_wide_output_kernel(const float* __restrict__ x,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ c,
                       const float* __restrict__ states,
                       float* __restrict__ y, int S, int H, int P, int N,
                       int T, int nc, int vec) {
  using repro::FragA;
  extern __shared__ double smem_d[];
  float* smem = reinterpret_cast<float*>(smem_d);
  float* cs = smem + Smem3::cs;
  float* bs = smem + Smem3::bs;
  float* sts = smem + Smem3::sts;
  float* xs = smem + Smem3::xs;
  float* gs = smem + Smem3::gs;
  float* as = smem + Smem3::as;
  float* din = smem + Smem3::din;
  double* cum = reinterpret_cast<double*>(smem + Smem3::cum);

  const int ch = blockIdx.x;
  const int pbase = blockIdx.y * kW;
  const int bh = blockIdx.z;
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const long long row0 = (long long)bi * S + (long long)ch * T;

  load_decays(as, a, row0, H, h, T);
  load_tile(xs, kXS, kT, x + (row0 * H + h) * P, (long long)H * P, T, pbase,
            P, vec);
  repro::cp_async_commit();
  for (int i = tid; i < kT * kGS; i += kThreads) gs[i] = 0.f;
  repro::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    chunk_cumsum(as, cum, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      din[t] = t < T ? expf((float)cum[t]) : 0.f;
    }
  }

  // each warp owns a 16-row band of G and y; bands pair up (0, 7), (1, 6),
  // (2, 5), (3, 4) on the SM's four sub-partitions, so each pair does the
  // same work (ssd_scan.cu's step 2)
  const int band = warp < 4 ? warp : 11 - warp;
  const int t0 = 16 * band;
  const int n_blk = 2 * band + 2;  // 8-column blocks at or left of diagonal
  const float* cbase = c + (row0 * H + h) * N;
  const float* bbase = b + (row0 * H + h) * N;
  const float* sbase = states + ((long long)bh * nc + ch) * P * N +
                       (long long)pbase * N;
  float ys[kW / 8][4];  // exp(cum[t]) C state^T, then + G x
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ys[n][e] = 0.f;

  const int n_ntiles = (N + kW - 1) / kW;
  for (int nt = 0; nt < n_ntiles; ++nt) {
    __syncthreads();  // the last tile is read (on the first: cum is ready)
    load_tile(cs, kRS, kT, cbase, (long long)H * N, T, nt * kW, N, vec);
    load_tile(bs, kRS, kT, bbase, (long long)H * N, T, nt * kW, N, vec);
    if (ch > 0)  // the state is zero before the first chunk
      load_tile(sts, kRS, kW, sbase, N, P - pbase, nt * kW, N, vec);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // the band's rows of this N tile of C, as A fragments
    FragA cf[kW / 8];
#pragma unroll
    for (int kk = 0; kk < kW / 8; ++kk) {
      const float* ca = cs + (t0 + g) * kRS + kk * 8 + t4;
      cf[kk] = FragA(ca[0], ca[8 * kRS], ca[4], ca[8 * kRS + 4]);
    }

    // C state^T over the tile, into a fresh accumulator, then added
    if (ch > 0) {
      float acc[kW / 8][4];
#pragma unroll
      for (int n = 0; n < kW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kW / 8; ++kk) {
#pragma unroll
        for (int n = 0; n < kW / 8; ++n) {
          const float* sp = sts + (8 * n + g) * kRS + kk * 8 + t4;
          repro::mma_3xtf32(acc[n], cf[kk], sp[0], sp[4]);
        }
      }
#pragma unroll
      for (int n = 0; n < kW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ys[n][e] += acc[n][e];
    }

    // C B^T of the band over the tile, two 8-column blocks at a time and
    // only those at or left of the diagonal, added into G (each warp
    // writes its own rows only)
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
      for (int kk = 0; kk < kW / 8; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* bb = bs + (8 * (j0 + jj) + g) * kRS + kk * 8 + t4;
          repro::mma_3xtf32(gsm[jj][kk & 1], gbg[jj][kk & 1], cf[kk],
                            bb[0], bb[4]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g + 8 * (e >> 1);
          const int s = 8 * (j0 + jj) + 2 * t4 + (e & 1);
          gs[t * kGS + s] += (gsm[jj][0][e] + gsm[jj][1][e]) +
                             (gbg[jj][0][e] + gbg[jj][1][e]);
        }
    }
  }
  __syncwarp();

  // G = mask(C B^T) exp(cum[t] - cum[s]) on the band, the mask before exp
  const int cols = 8 * n_blk;
  for (int i = lane; i < 16 * cols; i += 32) {
    const int r = i / cols;
    const int s = i - r * cols;
    const int t = t0 + r;
    float* gp = gs + t * kGS + s;
    *gp = s <= t ? *gp * expf((float)(cum[t] - cum[s])) : 0.f;
  }
  __syncwarp();

  // y = exp(cum[t]) (C state^T) + G x, the band's rows of the P tile
  const float d0 = din[t0 + g], d1 = din[t0 + g + 8];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n) {
    ys[n][0] *= d0;
    ys[n][1] *= d0;
    ys[n][2] *= d1;
    ys[n][3] *= d1;
  }
#pragma unroll 1
  for (int kb = 0; kb < n_blk; ++kb) {
    const float* ga = gs + (t0 + g) * kGS + 8 * kb + t4;
    const FragA fa(ga[0], ga[8 * kGS], ga[4], ga[8 * kGS + 4]);
    const float* xb = xs + (8 * kb + t4) * kXS + g;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n)
      repro::mma_3xtf32(ys[n], fa, xb[8 * n], xb[4 * kXS + 8 * n]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + g + 8 * r;
    if (t < T) {
      float* yr = y + ((row0 + t) * H + h) * P;
#pragma unroll
      for (int n = 0; n < kW / 8; ++n) {
        const int p = pbase + 8 * n + 2 * t4;
        if (p < P) yr[p] = ys[n][2 * r];
        if (p + 1 < P) yr[p + 1] = ys[n][2 * r + 1];
      }
    }
  }
}

}  // namespace

// The widest head the kernel takes (P and N alike).
extern "C" int ssd_scan_wide_max_width() { return kMaxWidth; }

// x, y [B, S, H, P]; a [B, S, H]; b, c [B, S, H, N]; fp32, contiguous.
// states [B, H, S / T, P, N] and totals [B, H, S / T] are fp32 scratch.
// T is the chunk (S % T == 0); T <= 128, P, N <= 256, B H <= 65535.
extern "C" int ssd_scan_wide_launch(const void* x, const void* a,
                                    const void* b, const void* c, void* y,
                                    void* states, void* totals, int B, int S,
                                    int H, int P, int N, int T,
                                    void* stream) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || P > kMaxWidth || N < 1 ||
      N > kMaxWidth || T < 1 || T > kT || S % T != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nc = S / T;
  const int vec =
      P % 4 == 0 && N % 4 == 0 &&
      (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)states) &
       15) == 0;
  const int n_ptiles = (P + kW - 1) / kW, n_ntiles = (N + kW - 1) / kW;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_wide_chunk_state_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem1::bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_wide_output_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Smem3::bytes);
  if (e != cudaSuccess) return (int)e;
  if (nc > 1) {  // one chunk: the state is zero throughout
    ssd_wide_chunk_state_kernel<<<dim3((unsigned)(nc - 1),
                                       (unsigned)(n_ptiles * n_ntiles),
                                       (unsigned)(B * H)),
                                  kThreads, Smem1::bytes, s>>>(
        (const float*)x, (const float*)a, (const float*)b, (float*)states,
        (float*)totals, S, H, P, N, T, nc, n_ntiles, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long PN = (long long)P * N;
    ssd_wide_carry_kernel<<<dim3((unsigned)((PN + 255) / 256),
                                 (unsigned)(B * H)),
                            256, 0, s>>>((float*)states,
                                         (const float*)totals, nc, PN);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_wide_output_kernel<<<dim3((unsigned)nc, (unsigned)n_ptiles,
                                (unsigned)(B * H)),
                           kThreads, Smem3::bytes, s>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)c,
      (const float*)states, (float*)y, S, H, P, N, T, nc, vec);
  return (int)cudaGetLastError();
}
