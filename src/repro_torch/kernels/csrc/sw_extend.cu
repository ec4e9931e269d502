// sw_extend: banded semi-global seed extension (merAligner's extend phase),
// the gapped verification of alignment.align_reads.
//
// Replaces the Pallas kernel repro/kernels/sw_extend.py:sw_extend (body
// `_kernel`); the plain version here is kernels/ref.py:sw_extend_ref, which
// computes what repro/kernels/ref.py:sw_extend_ref (the reference's CPU
// default) computes.  For each alignment b, the DP over query rows
// ii = 1..QL keeps the band j in [ii - band, ii + band] of target columns,
// stored target-relative at offset o = j - ii + band:
//
//   H[0][j]  = j * gap for 0 <= j <= min(tlen, band), else NEGINF
//   H[ii][0] = ii * gap
//   H[ii][j] = max(H[ii-1][j-1] + s(q[ii-1], t[j-1]),   diag, same offset
//                  H[ii-1][j] + gap,                     up, offset + 1
//                  H[ii][j-1] + gap)                     left, offset - 1
//
// with s = match when the bases are equal and < 4, else mismatch; a cell is
// valid when 0 <= j <= tlen and ii <= qlen, and every other cell is NEGINF
// once its row is done.  The best is the largest valid cell of rows >= 1;
// rows are scanned in order and a strictly greater score replaces the best
// (which starts at 0, so no positive cell gives (0, 0, 0)); within a row the
// first (lowest j) maximal cell is taken.  Outputs best score, ii and j.
//
// Bound on the H100: neither bytes (QL + TL + 8 bytes in, 12 out per
// alignment) nor arithmetic (~10 scalar operations per cell) comes close.
// Each row waits on the one before it, and within a row each cell on the
// one to its left; path 3's 32,768 pairs fill only ~8 warps an SM, so the
// time is these dependent chains' latency, which the issue of the other
// cells' work hides in part.  Design, one thread per alignment (as
// inter-task GPU aligners):
//   * the 2*band+1 <= 31 cells of a row live in a fully unrolled register
//     array (the band is a template parameter, one kernel per band);
//   * the left-gap chain is a running max in offset order,
//     c[o] = max(c[o], c[o-1] + gap), which for a linear gap equals the
//     max over d of c[o-d] + d * gap exactly: no scan, no shuffle;
//   * up and left terms are one DPX instruction each (__viaddmax_s32:
//     max(a + b, c));
//   * the row's first maximum is the max of c * 32 + (31 - o), a tree of
//     three-input maxima, not a chain; a strictly greater row maximum
//     replaces the best.  The launcher takes this form when every cell
//     stays within +-2^26 (scores of |weight| * (QL + TL + 1) < 2^25);
//     else a chain over the cells in row order (__vibmax_s32), exact at
//     any weights;
//   * the substitution comes from a one-hot mask of the target window
//     for the row's query base, three bit planes of the window (the
//     base's two bits, and base < 4) shifted one place a row with one
//     target base brought in: a row reads one query byte and one target
//     byte, and takes no branch;
//   * rows stop at min(QL, qlen, tlen + band): later rows hold no valid
//     cell.  A pair with qlen == 0 (no candidate) writes (0, 0, 0) at once.
//     Rows whose band lies inside [0, tlen] skip the validity masks;
//   * a block of 32 pairs (one warp; 64 and 128 ran slower) stages its
//     pairs' query and target rows in shared memory with 16-byte loads,
//     transposed so a warp's byte reads of one column are one run.
#include <algorithm>
#include <climits>
#include <cstdlib>

#include "common.cuh"

namespace {

constexpr int kNegInf = -(1 << 20);
constexpr int kMaxBand = 15;
constexpr int kMaxPairs = 32;  // alignments a block, one a thread
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;

// dst[i * P + r] = src[r * len + i] for the n rows of len bytes at src.
__device__ void stage_transposed(const uint8_t* __restrict__ src, int n,
                                 int len, int P, uint8_t* __restrict__ dst) {
  const int nbytes = n * len;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = nbytes / 16;
    for (int c = threadIdx.x; c < n16; c += blockDim.x) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      int r = c * 16 / len;
      int i = c * 16 - r * len;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        dst[i * P + r] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
        if (++i == len) {
          i = 0;
          ++r;
        }
      }
    }
    done = n16 * 16;
  }
  for (int x = done + threadIdx.x; x < nbytes; x += blockDim.x) {
    const int r = x / len;
    dst[(x - r * len) * P + r] = src[x];
  }
}

// The target window of one alignment as bit planes: bit o of lo / hi is
// bit 0 / 1 of the target base under offset o, bit o of ok that the base
// is < 4.  Branch-free, so a row is one basic block.
struct Window {
  uint32_t lo = 0, hi = 0, ok = 0;

  __device__ __forceinline__ void put(uint32_t base, int bit) {
    lo |= (base & 1u) << bit;
    hi |= ((base >> 1) & 1u) << bit;
    ok |= (base < 4u ? 1u : 0u) << bit;
  }
  __device__ __forceinline__ void shift() {
    lo >>= 1;
    hi >>= 1;
    ok >>= 1;
  }
  // one-hot mask of the cells whose target base equals query base q (none
  // for q >= 4)
  __device__ __forceinline__ uint32_t matches(uint32_t q) const {
    const uint32_t qlo = 0u - (q & 1u), qhi = 0u - ((q >> 1) & 1u);
    return q < 4u ? ok & ~(lo ^ qlo) & ~(hi ^ qhi) : 0u;
  }
};

// KEYED: the row's first maximum is the max of c * 32 + 31 - o, a tree
// of three-input maxima (exact while every cell is within +-2^26, which
// the launcher checks); else it is tracked cell by cell, a chain.
template <int BAND, bool KEYED>
struct Dp {
  static constexpr int W = 2 * BAND + 1;
  int h[W];  // the previous row, then this one
  int best = 0, best_row = 0, best_off = 0;

  // Row ii over the cells whose target base equals the query base in
  // `hit`.  MASKED: the row may hold cells outside [0, tlen] (the first
  // and last band rows); every other row is valid across the band.
  template <bool MASKED>
  __device__ __forceinline__ void row(int ii, uint32_t hit, int tlen,
                                      int match, int mismatch, int gap) {
    const int j0_off = BAND - ii;          // offset of j == 0
    const int last_off = tlen - ii + BAND;  // offset of j == tlen
    const int row_start = best;
    int left = 0;
    int key = INT_MIN;
#pragma unroll
    for (int o = 0; o < W; ++o) {
      const int sub = (hit >> o) & 1u ? match : mismatch;
      const int up = (o + 1 < W ? h[o + 1] : kNegInf) + gap;
      int c = __viaddmax_s32(h[o], sub, up);  // max(diag + sub, up + gap)
      if (MASKED && o == j0_off) c = ii * gap;
      if (o > 0) c = __viaddmax_s32(left, gap, c);  // left + gap
      left = c;
      if (MASKED && (o < j0_off || o > last_off)) c = kNegInf;
      h[o] = c;
      if (KEYED) {
        key = max(key, c * 32 + (31 - o));
      } else {
        bool keep;
        best = __vibmax_s32(best, c, &keep);  // keep: best >= c
        best_off = keep ? best_off : o;
      }
    }
    if (KEYED) {
      const int m = key >> 5;
      const bool better = m > best;
      best = better ? m : best;
      best_off = better ? 31 - (key & 31) : best_off;
      best_row = better ? ii : best_row;
    } else if (best != row_start) {
      best_row = ii;
    }
  }
};

template <int BAND, bool KEYED>
__global__ void __launch_bounds__(kMaxPairs)
    sw_extend_kernel(const uint8_t* __restrict__ query,
                     const uint8_t* __restrict__ target,
                     const int32_t* __restrict__ qlen_p,
                     const int32_t* __restrict__ tlen_p, long long B, int QL,
                     int TL, int match, int mismatch, int gap,
                     int32_t* __restrict__ best_score,
                     int32_t* __restrict__ best_q,
                     int32_t* __restrict__ best_t) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = blockDim.x;
  const long long b0 = (long long)blockIdx.x * P;
  const int n = (int)min((long long)P, B - b0);
  uint8_t* qs = smem;                  // qs[i * P + p] = query[b0 + p][i]
  uint8_t* ts = smem + (size_t)P * QL;  // ts[c * P + p] = target[b0 + p][c]
  stage_transposed(query + b0 * QL, n, QL, P, qs);
  if (TL > 0) stage_transposed(target + b0 * TL, n, TL, P, ts);
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= n) return;
  const long long b = b0 + p;
  const int qlen = qlen_p[b];
  const int tlen = tlen_p[b];
  const int stop = min(QL, min(qlen, tlen + BAND));
  Dp<BAND, KEYED> dp;
  if (stop > 0) {
    constexpr int W = Dp<BAND, KEYED>::W;
    // row 0: H[0][j] = j * gap for 0 <= j <= min(tlen, band), o = j + band
    const int j0_max = min(tlen, BAND);
#pragma unroll
    for (int o = 0; o < W; ++o) {
      const int j = o - BAND;
      dp.h[o] = (j >= 0 && j <= j0_max) ? j * gap : kNegInf;
    }
    // Row ii reads target column j - 1 = ii - band - 1 + o at offset o.
    // Columns 0 .. band-1 sit at row 1's offsets band+1 .. 2 band before
    // the row's shift; each row then brings in column ii + band - 1.
    Window win;
    for (int c = 0; c < min(BAND, TL); ++c)
      win.put(ts[c * P + p], c + BAND + 1);
    const auto advance = [&](int ii) {
      win.shift();
      const int c = ii + BAND - 1;
      win.put(c < TL ? ts[c * P + p] : 4u, W - 1);
      return win.matches(qs[(ii - 1) * P + p]);
    };
    const int head_end = min(stop, BAND);           // rows 1 .. band
    const int body_end = min(stop, tlen - BAND);    // band inside [0, tlen]
    int ii = 1;
    for (; ii <= head_end; ++ii)
      dp.template row<true>(ii, advance(ii), tlen, match, mismatch, gap);
    for (; ii <= body_end; ++ii)
      dp.template row<false>(ii, advance(ii), tlen, match, mismatch, gap);
    for (; ii <= stop; ++ii)
      dp.template row<true>(ii, advance(ii), tlen, match, mismatch, gap);
  }
  const bool any = dp.best > 0;
  best_score[b] = dp.best;
  best_q[b] = any ? dp.best_row : 0;
  best_t[b] = any ? dp.best_row - BAND + dp.best_off : 0;
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*,
                        const int32_t*, long long, int, int, int, int, int,
                        int32_t*, int32_t*, int32_t*);

template <bool KEYED>
Kernel kernel_of(int band) {
  static const Kernel of[kMaxBand + 1] = {
      sw_extend_kernel<0, KEYED>,  sw_extend_kernel<1, KEYED>,
      sw_extend_kernel<2, KEYED>,  sw_extend_kernel<3, KEYED>,
      sw_extend_kernel<4, KEYED>,  sw_extend_kernel<5, KEYED>,
      sw_extend_kernel<6, KEYED>,  sw_extend_kernel<7, KEYED>,
      sw_extend_kernel<8, KEYED>,  sw_extend_kernel<9, KEYED>,
      sw_extend_kernel<10, KEYED>, sw_extend_kernel<11, KEYED>,
      sw_extend_kernel<12, KEYED>, sw_extend_kernel<13, KEYED>,
      sw_extend_kernel<14, KEYED>, sw_extend_kernel<15, KEYED>};
  return of[band];
}

}  // namespace

extern "C" int sw_extend_max_band() { return kMaxBand; }

extern "C" int sw_extend_launch(const void* query, const void* target,
                                const void* qlen, const void* tlen,
                                long long B, int QL, int TL, int band,
                                int match, int mismatch, int gap,
                                void* best_score, void* best_q, void* best_t,
                                void* stream) {
  if (band < 0 || band > kMaxBand || QL < 1 || TL < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // pairs a block: a multiple of 16 (so every block's rows start on a
  // 16-byte boundary of an aligned tensor) whose rows fit the default
  // shared memory, else 16 with more shared memory
  int P = kMaxPairs;
  while (P > 16 && (size_t)P * (QL + TL) > kDefaultSmem) P >>= 1;
  const size_t smem = (size_t)P * (QL + TL);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // cells are path scores from (0, 0) within +-(QL + TL) * the largest
  // weight, or NEGINF: keyed when 32 times that stays inside int32
  const long long weight = std::max({std::abs((long long)match),
                                     std::abs((long long)mismatch),
                                     std::abs((long long)gap)});
  const bool keyed = (long long)(QL + TL + 1) * weight < (1 << 25);
  const Kernel kernel = keyed ? kernel_of<true>(band) : kernel_of<false>(band);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + P - 1) / P;
  kernel<<<(unsigned)blocks, P, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const uint8_t*)target, (const int32_t*)qlen,
      (const int32_t*)tlen, B, QL, TL, match, mismatch, gap,
      (int32_t*)best_score, (int32_t*)best_q, (int32_t*)best_t);
  return (int)cudaGetLastError();
}
