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
// (three 4-byte lanes, four 1-byte lanes).  What a thread does per window
// is kept far below the issue rate:
//   * a thread takes kV consecutive windows of the flattened [R, L] array:
//     it packs the first window's first k - 1 bases from shared memory,
//     four from each 32-bit word, then rolls one base a window,
//     code = ((code << 2) | entering base) & mask, with a rolling count of
//     N bases (+1 entering, -1 leaving).  Rolling over the flattened array
//     is right for every window inside its row: such a window's bases are
//     contiguous there, and a base that leaves lands at bit 2k or above and
//     is masked off.  Windows that straddle two rows are padding columns,
//     which write constants;
//   * one division a thread (row and column of its first window), 32-bit
//     whenever R * L < 2^32; the column then steps by one;
//   * a block stages the bases its windows span with 16-byte loads;
//   * each 4-byte lane is stored as 16-byte vectors over 4 windows, each
//     1-byte lane as one 32-bit word per 4 windows; the last thread of a
//     batch whose R * L is not a multiple of kV stores window by window.
//     With kV = 4 each store instruction of a warp writes one run; more
//     windows a thread stride the lanes' stores and ran slower.
// The reverse complement is taken of each code (a 64-bit reversal), not
// rolled.
//
// Packing ORs each base in unmasked, as repro/core/kmer.py:append_base does:
// an N (code 4) sets bit 2 of the low lane.  Such windows are invalid, but
// their lanes are compared bit for bit all the same.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;                          // windows a thread
constexpr int kTileWindows = kThreads * kV;    // windows a block
constexpr int kHalo = 16;                      // staged bases before the tile
constexpr int kTail = 32;                      // ... and after it (k <= 31)
constexpr int kStaged = kHalo + kTileWindows + kTail;
static_assert(kV % 4 == 0 && kStaged % 16 == 0, "vector widths");

__global__ void __launch_bounds__(kThreads)
    kmer_extract_kernel(const uint8_t* __restrict__ bases,
                        const int32_t* __restrict__ lengths, long long R,
                        long long L, int k, uint32_t* __restrict__ out_hi,
                        uint32_t* __restrict__ out_lo,
                        uint32_t* __restrict__ out_hash,
                        uint8_t* __restrict__ out_left,
                        uint8_t* __restrict__ out_right,
                        uint8_t* __restrict__ out_flip,
                        uint8_t* __restrict__ out_valid) {
  __shared__ __align__(16) uint8_t tile[kStaged];  // bases[G0 - kHalo, ...)
  const long long total = R * L;
  const long long G0 = (long long)blockIdx.x * kTileWindows;
  const bool vec = ((uintptr_t)bases & 15) == 0;
  for (int c = threadIdx.x; c < kStaged / 16; c += kThreads) {
    const long long src = G0 - kHalo + 16 * c;
    uint4 v;
    if (vec && src >= 0 && src + 16 <= total) {
      v = __ldg((const uint4*)(bases + src));
    } else {  // the batch's edges: bases outside it read as N
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long s = src + 4 * q + b;
          const uint32_t x = (s >= 0 && s < total) ? bases[s] : 4u;
          w[q] |= x << (8 * b);
        }
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *(uint4*)(tile + 16 * c) = v;
  }
  __syncthreads();

  const long long g0 = G0 + (long long)threadIdx.x * kV;
  if (g0 >= total) return;
  long long r;
  int pos;
  if (total <= 0xFFFFFFFFll) {
    const uint32_t q = (uint32_t)g0 / (uint32_t)L;
    r = q;
    pos = (int)((uint32_t)g0 - q * (uint32_t)L);
  } else {
    r = g0 / L;
    pos = (int)(g0 - r * L);
  }
  const int W = (int)L - k + 1;
  int len = lengths[r];
  const uint8_t* t = tile + kHalo + threadIdx.x * kV;  // t[j] = bases[g0 + j]
  const uint64_t mask = repro::code_mask(k);
  // the first window's first k - 1 bases, four at a time from one word:
  // code << 8 | b0 << 6 | b1 << 4 | b2 << 2 | b3 is four appends, N bits
  // included; __vcmpgeu4 flags the bytes that are N
  uint64_t code = 0;
  int n_count = 0;  // N bases among the window's first k - 1
  int i = 0;
  for (; i + 4 <= k - 1; i += 4) {
    const uint32_t x = *(const uint32_t*)(t + i);
    code = (code << 8) | ((x & 0xFF) << 6) | (((x >> 8) & 0xFF) << 4) |
           (((x >> 16) & 0xFF) << 2) | (x >> 24);
    n_count += __popc(__vcmpgeu4(x, 0x04040404u)) >> 3;
  }
  for (; i < k - 1; ++i) {
    const uint8_t b = t[i];
    code = (code << 2) | b;
    n_count += b >= 4;
  }

  // kV windows, stored four at a time
  const bool full = g0 + kV <= total;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    uint32_t hi[4], lo[4], hash[4];
    uint32_t left4 = 0, right4 = 0, flip4 = 0, valid4 = 0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj;
      const uint8_t enter = t[j + k - 1];  // window j's last base
      const uint8_t before = t[j - 1];     // its left neighbour
      const uint8_t after = t[j + k];      // its right neighbour
      code = ((code << 2) | enter) & mask;  // unmasked base, as append_base
      n_count += enter >= 4;
      uint32_t h = 0, l = 0, hs = 0, lf = 4, rt = 4, fl = 0, va = 0;
      if (pos < W) {
        bool flip;
        const uint64_t c = repro::canonical(code, k, &flip);
        h = (uint32_t)(c >> 32);
        l = (uint32_t)c;
        hs = repro::kmer_hash(h, l);
        const uint8_t left_f = pos > 0 ? before : (uint8_t)4;
        const uint8_t right_f =
            (pos + k < L && pos + k < len) ? after : (uint8_t)4;
        lf = flip ? repro::complement_base(right_f) : left_f;
        rt = flip ? repro::complement_base(left_f) : right_f;
        fl = flip;
        va = n_count == 0 && pos + k <= len;
      }
      hi[jj] = h, lo[jj] = l, hash[jj] = hs;
      left4 |= lf << (8 * jj);
      right4 |= rt << (8 * jj);
      flip4 |= fl << (8 * jj);
      valid4 |= va << (8 * jj);
      n_count -= t[j] >= 4;  // window j's first base leaves
      if (++pos == L && g0 + j + 1 < total) {
        pos = 0;
        len = lengths[++r];
      }
    }
    const long long g = g0 + 4 * q;
    if (full) {
      *(uint4*)(out_hi + g) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *(uint4*)(out_lo + g) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *(uint4*)(out_hash + g) = make_uint4(hash[0], hash[1], hash[2], hash[3]);
      *(uint32_t*)(out_left + g) = left4;
      *(uint32_t*)(out_right + g) = right4;
      *(uint32_t*)(out_flip + g) = flip4;
      *(uint32_t*)(out_valid + g) = valid4;
    } else {  // the batch's last thread, R * L not a multiple of kV
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (g + jj < total) {
          out_hi[g + jj] = hi[jj];
          out_lo[g + jj] = lo[jj];
          out_hash[g + jj] = hash[jj];
          out_left[g + jj] = (uint8_t)(left4 >> (8 * jj));
          out_right[g + jj] = (uint8_t)(right4 >> (8 * jj));
          out_flip[g + jj] = (uint8_t)(flip4 >> (8 * jj));
          out_valid[g + jj] = (uint8_t)(valid4 >> (8 * jj));
        }
      }
    }
  }
}

}  // namespace

// The outputs are allocated by the caller, 16-byte aligned (vector stores).
extern "C" int kmer_extract_launch(const void* bases, const void* lengths,
                                   long long R, long long L, int k,
                                   void* hi, void* lo, void* hash, void* left,
                                   void* right, void* flip, void* valid,
                                   void* stream) {
  const long long total = R * L;
  if (total == 0) return 0;
  const long long blocks = (total + kTileWindows - 1) / kTileWindows;
  kmer_extract_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, R, L, k,
      (uint32_t*)hi, (uint32_t*)lo, (uint32_t*)hash, (uint8_t*)left,
      (uint8_t*)right, (uint8_t*)flip, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
