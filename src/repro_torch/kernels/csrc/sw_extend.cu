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
// alignment) nor arithmetic (~10 scalar operations per cell) comes close;
// each row waits on the one before it, so the time is the latency of the
// row chain times the waves of warps.
// Design: one warp per alignment, lane o holding band offset o (2*band+1
// <= 31 lanes; lanes past the band hold NEGINF).  The query and target
// rows are staged in shared memory.  Per row, diag comes from the lane's
// own register, up from lane o+1 (__shfl_down_sync), and the left-gap
// chain is an exact Hillis-Steele max-plus scan: five __shfl_up_sync
// rounds at distances 1, 2, 4, 8, 16 with penalties d * gap.  The best
// is tracked per lane (score and the first row that reached it) and
// reduced once at the end: the largest score, then its first row, then
// the lowest offset, which is the row-major first-maximum rule above.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // alignments per block
constexpr int kNegInf = -(1 << 20);
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void sw_extend_kernel(const uint8_t* __restrict__ query,
                                 const uint8_t* __restrict__ target,
                                 const int32_t* __restrict__ qlen_p,
                                 const int32_t* __restrict__ tlen_p,
                                 long long B, int QL, int TL, int band,
                                 int match, int mismatch, int gap,
                                 int32_t* __restrict__ best_score,
                                 int32_t* __restrict__ best_q,
                                 int32_t* __restrict__ best_t) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int o = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps leave together
  uint8_t* q = smem + warp * (QL + TL);
  uint8_t* t = q + QL;
  for (int i = o; i < QL; i += 32) q[i] = query[b * QL + i];
  for (int i = o; i < TL; i += 32) t[i] = target[b * TL + i];
  __syncwarp();
  const int qlen = qlen_p[b];
  const int tlen = tlen_p[b];
  const int bw = 2 * band + 1;
  const bool in_band = o < bw;
  // row 0: H[0][j] = j * gap for 0 <= j <= min(tlen, band)
  const int j0 = o - band;
  int h = (in_band && j0 >= 0 && j0 <= min(tlen, band)) ? j0 * gap : kNegInf;
  int best = 0, best_row = 0;
  for (int i = 0; i < QL; ++i) {
    const int ii = i + 1;
    const int j = ii - band + o;
    const int up_src = __shfl_down_sync(kFull, h, 1);  // lane 31: own value
    const uint8_t qi = q[i];
    const uint8_t tj = (j >= 1 && j <= TL) ? t[j - 1] : (uint8_t)4;
    const int sub = (qi == tj && qi < 4) ? match : mismatch;
    int c = max(h + sub, (o + 1 < bw ? up_src : kNegInf) + gap);
    if (j == 0) c = ii * gap;
    // left chain: c[o] = max over d in [0, 32) of c[o - d] + d * gap
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, c, d);
      if (o >= d) c = max(c, v + d * gap);
    }
    const bool valid = in_band && j >= 0 && j <= tlen && ii <= qlen;
    h = valid ? c : kNegInf;
    if (h > best) {
      best = h;
      best_row = ii;
    }
  }
  // largest score, then its first row, then the lowest offset
  int off = o;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, s);
    const int orow = __shfl_xor_sync(kFull, best_row, s);
    const int ooff = __shfl_xor_sync(kFull, off, s);
    if (ob > best || (ob == best && (orow < best_row ||
                                     (orow == best_row && ooff < off)))) {
      best = ob;
      best_row = orow;
      off = ooff;
    }
  }
  if (o == 0) {
    const bool any = best > 0;
    best_score[b] = any ? best : 0;
    best_q[b] = any ? best_row : 0;
    best_t[b] = any ? best_row - band + off : 0;
  }
}

}  // namespace

extern "C" int sw_extend_max_band() { return 15; }

extern "C" int sw_extend_launch(const void* query, const void* target,
                                const void* qlen, const void* tlen,
                                long long B, int QL, int TL, int band,
                                int match, int mismatch, int gap,
                                void* best_score, void* best_q, void* best_t,
                                void* stream) {
  if (band < 0 || band > 15 || QL < 1 || TL < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)kWarps * (QL + TL);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + kWarps - 1) / kWarps;
  sw_extend_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const uint8_t*)target, (const int32_t*)qlen,
      (const int32_t*)tlen, B, QL, TL, band, match, mismatch, gap,
      (int32_t*)best_score, (int32_t*)best_q, (int32_t*)best_t);
  return (int)cudaGetLastError();
}
