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
// Bound on the H100 at the xLSTM prefill's call (B 2, S 4096, H 4, P = N =
// 192, T 128): operations.  C B^T and G x over the T (T + 1) / 2 causal
// pairs of a chunk (2 N and 2 P flops a pair), C . state and the state
// update (2 T P N flops each) in all but the first chunk: 6.30 GFLOP,
// 0.038 ms at 165 TFLOP/s (3xTF32); x, b, c, y and a, 100.8 MB, take
// 0.030 ms at 3.35 TB/s.  The carried states are scratch the bound does
// not count; this design writes them once and reads them once (36.6 MB
// each way), so its own byte floor is 173.9 MB, 0.052 ms.  At long_500k's
// call (B 1, S 524,288) the bound is 2.50 ms and the byte floor 3.37 ms
// (6.45 GB of inputs and output, 2 x 2.42 GB of states): above the bound.
//
// Design (this replaces a first version that ran mma.sync fed by scalar
// shared loads, rebuilt C B^T for each 64-wide P tile, and passed the
// states through device memory four times):
//
// * Every product on wgmma (TF32, m64nNk8), the tensor cores' full-rate
//   instruction, in 3xTF32: A from registers, split as tf32.cuh splits it
//   (hi rounded half away from zero, lo = a - hi); B from shared memory
//   as two K-major, 128-byte-swizzled tiles hi and lo, split the same way
//   once they have landed.  d = a_lo b_hi + a_hi b_lo + a_hi b_hi a
//   k-step, small terms first.  TF32 wgmma takes both operands K-major,
//   so the B operands that run along s (x in G x and in the state update)
//   are written transposed from registers while they are split.  The
//   tensor core's accumulator rounds toward zero, so no chain is longer
//   than one 32-deep atom (4 k-steps, 12 wgmmas) into a fresh
//   accumulator; atoms are summed by fp32 adds (as ssd_scan.cu and the
//   first version kept their chains short).  tests/test_torch_tf32_split.py
//   emulates this order at P = N = 192 against float64.
// * The G x product takes G from the accumulators of C B^T: the
//   accumulator of columns 2t, 2t + 1 is the A fragment of k slots t,
//   t + 4, so the transposed x tile stores each 8-row group of s in the
//   order 0 2 4 6 1 3 5 7.
// * Each (b, h, chunk)'s G once.  One output CTA a chunk, two warpgroups:
//   rows t 0-63 (G over s < 64) and 64-127 (all s).  Each forms its rows
//   of G over every N atom, keeps them in registers and loops over the P
//   tiles: C state^T over the N atoms, times exp(cum[t]), then + G x.
//   Both multiply the same B, state and x tiles, so each is loaded and
//   split once a chunk.
// * Loads overlap the products: C (once) and the B and state tiles come
//   by TMA (128-byte swizzle, rows past T zero-filled) into a three-slot
//   ring reported by mbarriers, issued two items ahead of the one being
//   multiplied; x, which must be transposed, comes through registers one
//   item ahead.  The splits run on all threads between two barriers an
//   item: a producer warp would cap the consumers at 168 registers (a
//   third warp on an SM sub-partition) and they hold G, y and the
//   fragments in ~245.
// * The states cross device memory once each way.  A state CTA owns a
//   64-wide P tile of one (b, h), one warpgroup a 64-wide N tile sharing
//   each split x tile, and walks a run of R consecutive chunks, its
//   running sum in registers: it writes the partial state entering each
//   chunk of the run (from zero at the run's start) and the product of
//   the chunk decays since the run's start.  A carry launch then walks the
//   runs only (R chunks apart), turning the first slot of each run into
//   the true state entering it; the output CTA adds decay x that slot to
//   the partial state as it splits it.  R is chosen so that the state
//   launch fills the SMs once.
//
// P and N are multiples of 64 and every pointer is 16-byte aligned (the
// wrapper pads other heads with zeros); T <= 128 is a runtime size.
// Scratch: `states` [B, H, nc, P, N] and `totals` [B, H, nc], fp32, from
// the wrapper (slot 0 unused); the kernels allocate nothing.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using repro::EncodeTiled;
using repro::encode_tiled;
using repro::fence_proxy_async;
using repro::fence_regs;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::tma_load_3d;
using repro::tma_load_4d;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_wait_all;

constexpr int kT = 128;         // rows of a chunk, at most
constexpr int kMaxWidth = 256;  // P, N at most (ops.py: _SSD_WIDE_MAX)
constexpr int kSlot = 32768;    // bytes of a ring slot: hi, then lo
constexpr int kRing = 3;        // output ring slots
constexpr int kAtom = 16384;    // bytes of a C or B tile: 128 rows x 32
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const float* x;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* states;
  float* totals;
  int S, H, P, N, T, nc, R;
};

// ------------------------------------------------------------ wgmma

// K-major operand, 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return repro::smem_desc(addr, 0, 1024);
}

// byte offset of (row r, column c < 32) in a tile of rows x one 32-float
// atom, 128-byte swizzled as TMA writes it: the 16-byte chunk c / 4 of
// row r lands at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((r >> 3) * 1024 + (r & 7) * 128 +
                    ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64]; A in registers (TF32), B K-major
// in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128]
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_n64(d, a, db, accumulate);
  else wgmma_n128(d, a, db, accumulate);
}

// d = A B over one 32-deep atom into a fresh d: four k-steps of 3xTF32
// (a_lo b_hi, a_hi b_lo, a_hi b_hi), A's fragments given, B's hi and lo
// tiles (N rows, one atom) at shared addresses bhi and blo
template <int N>
__device__ __forceinline__ void atom_product(float (&d)[N / 2],
                                             const repro::FragA (&fa)[4],
                                             uint32_t bhi, uint32_t blo) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dh = smem_desc(bhi + 32 * kk);
    const uint64_t dl = smem_desc(blo + 32 * kk);
    wgmma_tf32<N>(d, fa[kk].lo, dh, kk > 0);
    wgmma_tf32<N>(d, fa[kk].hi, dl, 1);
    wgmma_tf32<N>(d, fa[kk].hi, dh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// ------------------------------------------------------------ tiles

// The split of tf32.cuh on four values: hi rounded, lo = v - hi.
__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  hi = make_float4(__uint_as_float(repro::to_tf32(v.x)),
                   __uint_as_float(repro::to_tf32(v.y)),
                   __uint_as_float(repro::to_tf32(v.z)),
                   __uint_as_float(repro::to_tf32(v.w)));
  lo = make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
}

// A tile landed raw in its hi half becomes hi and lo (the lo half sits
// `bytes` after the hi one); with `add`, the lo half holds a second raw
// tile E first and the tile is hi + dec E.  Every thread of the CTA.
__device__ __forceinline__ void split_tile(uint8_t* hi, int bytes, bool add,
                                           float dec) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(hi + bytes);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    float4 v = h4[i];
    if (add) {
      const float4 e = l4[i];
      v = make_float4(fmaf(dec, e.x, v.x), fmaf(dec, e.y, v.y),
                      fmaf(dec, e.z, v.z), fmaf(dec, e.w, v.w));
    }
    float4 h, l;
    split4(v, h, l);
    h4[i] = h;
    l4[i] = l;
  }
}

// A 64 (s) x 64 (p) tile of x into registers by the CTA's first W warps:
// block bid = W it + warp covers p in 8 (bid % 8) .. + 7 and s in 16 (bid
// / 8) .. + 15, lane l the 4 p at 4 (l % 2) .. and the s l / 2, so that
// store_xt's scalar stores meet no bank twice.  Rows >= nrows read as
// zero; base is 16-byte aligned and the pitch a multiple of 4.
template <int W>
__device__ __forceinline__ void load_x(float4 (&xr)[32 / W],
                                       const float* __restrict__ base,
                                       long long pitch, int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < 32 / W; ++it) {
    const int bid = W * it + warp;
    const int s = 16 * (bid >> 3) + (lane >> 1);
    const int p = 8 * (bid & 7) + 4 * (lane & 1);
    xr[it] = s < nrows ? __ldg(reinterpret_cast<const float4*>(
                             base + s * pitch + p))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// load_x's tile, split, as the K-major B operand x^T [64 p][64 s]: two
// atoms of 32 s (8192 bytes each), hi at `hi` and lo 16384 bytes after.
// Within each 8-row group of s the k slots hold s in the order 0 2 4 6 1 3
// 5 7 (slot j <- s = 2 j, slot j + 4 <- 2 j + 1): the order in which an
// accumulator's columns 2t, 2t + 1 become A's k slots t, t + 4.
template <int W>
__device__ __forceinline__ void store_xt(uint8_t* hi,
                                         const float4 (&xr)[32 / W]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < 32 / W; ++it) {
    const int bid = W * it + warp;
    const int s = 16 * (bid >> 3) + (lane >> 1);
    const int p0 = 8 * (bid & 7) + 4 * (lane & 1);
    const int m = s & 7;
    const int col = (s & 24) | (m >> 1) | ((m & 1) << 2);
    float4 h, l;
    split4(xr[it], h, l);
    const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = (s >> 5) * 8192 + swz(p0 + e, col);
      *reinterpret_cast<float*>(hi + off) = hv[e];
      *reinterpret_cast<float*>(hi + 16384 + off) = lv[e];
    }
  }
}

// cum = cumsum(as[0..127]) in fp64 by one warp (4 rows a lane, then a
// shuffle scan); each lane gets its 4 values and the last
__device__ __forceinline__ void chunk_cumsum(double (&v)[4], double& last,
                                             const float (&as)[4],
                                             int lane) {
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += (double)as[i];
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
  for (int i = 0; i < 4; ++i) v[i] += off;
  last = __shfl_sync(kFull, incl, 31);
}

// ------------------------------------------------------------ states

// Per (64-wide P tile, run of R chunks, b h), one warpgroup a 64-wide N
// tile (W = N / 64): the chunks' hand-ons upd[n][p] = sum_s tail[s]
// B[s][n] x[s][p] (M = n, N = p, K = s; A = (B tail)^T gathered from B, B
// operand = x^T, split once for all W warpgroups), the running partial
// state in registers (scaled by the chunk's decay, then each atom's
// product added), written entering each chunk after the run's first.
// Items of 64 rows s through a two-slot ring, one item ahead: B by TMA
// (2 W swizzled atoms of 32 n), x through registers.
__host__ __device__ constexpr int st_slot(int W) {  // x^T hi, lo; B
  return 32768 + W * 16384;
}
__host__ __device__ constexpr int st_smem(int W) {
  return 1024 + 2 * st_slot(W) + 4 * (3 * kT + 1);
}

template <int W>
__global__ void __launch_bounds__(128 * W, 1)
ssd_wide_state_kernel(const __grid_constant__ CUtensorMap tb,
                      const Args A) {
  constexpr int XW = W == 1 ? 4 : 8;  // the warps that move x
  constexpr int kSl = st_slot(W);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];  // B landed, a slot each
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  float* a_s = reinterpret_cast<float*>(smem + 2 * kSl);  // [2][kT]
  float* tail = a_s + 2 * kT;                             // [kT]
  float* tot_s = tail + kT;                               // [1]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;  // this warpgroup's N tile
  const int pt = blockIdx.x;
  const int bh = blockIdx.z, bi = bh / A.H, hh = bh - bi * A.H;
  const int c_begin = blockIdx.y * A.R;
  const int c_end = min(c_begin + A.R, A.nc - 1);
  const int ipc = (A.T + 63) / 64;  // items (64 rows s) a chunk
  const int n_items = (c_end - c_begin) * ipc;
  const uint32_t box_bytes = 128 * min(64, A.T);
  if (n_items <= 0) return;
  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (A.T < 64) {  // rows of B past T are never copied: keep them zero
    for (int k = tid; k < 2 * W * 4096; k += 128 * W) {
      const int sl = k / (W * 4096), r = k - sl * W * 4096;
      reinterpret_cast<float*>(smem + sl * kSl + 32768)[r] = 0.f;
    }
    fence_proxy_async();
  }
  __syncthreads();

  float4 xr[32 / XW];
  auto issue = [&](int i) {  // item i: B by TMA, x into registers, a
    const int ch = c_begin + i / ipc, sh = i - (i / ipc) * ipc;
    const long long row0 = (long long)bi * A.S + (long long)ch * A.T;
    if (tid == 0) {
      const uint32_t bar = smem_u32(&bars[i & 1]);
      mbar_expect_tx(bar, 2 * W * box_bytes);
      for (int k = 0; k < 2 * W; ++k)
        tma_load_4d(base + (i & 1) * kSl + 32768 + 8192 * k, &tb, bar,
                    32 * k, hh, 64 * sh, bi * A.nc + ch);
    }
    if (warp < XW)
      load_x<XW>(xr, A.x + ((row0 + 64 * sh) * A.H + hh) * A.P + 64 * pt,
                 (long long)A.H * A.P, A.T - 64 * sh);
    if (sh == 0 && tid < kT) {
      float* as = a_s + (ch & 1) * kT;
      if (tid < A.T) repro::cp_async4(as + tid, A.a + (row0 + tid) * A.H + hh);
      else as[tid] = 0.f;
    }
    repro::cp_async_commit();
  };
  auto finish = [&](int i) {  // x^T split; the chunk's decays
    const int ch = c_begin + i / ipc, sh = i - (i / ipc) * ipc;
    if (warp < XW) store_xt<XW>(smem + (i & 1) * kSl, xr);
    if (sh == 0 && warp == 0) {
      const float* as = a_s + (ch & 1) * kT + lane * 4;
      const float av[4] = {as[0], as[1], as[2], as[3]};
      double v[4], last;
      chunk_cumsum(v, last, av, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        tail[t] = t < A.T ? expf((float)(last - v[k])) : 0.f;
      }
      if (lane == 0) *tot_s = expf((float)last);
    }
  };

  issue(0);
  repro::cp_async_wait<0>();
  __syncthreads();
  finish(0);
  if (n_items > 1) issue(1);
  fence_proxy_async();
  __syncthreads();

  const int n0 = 16 * (warp & 3) + g;  // rows n0, n0 + 8 of the N tile
  float st[32];  // the partial state entering the chunk, then leaving it
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;
  float dec = 1.f;  // product of the chunk decays since the run's start
  for (int i = 0; i < n_items; ++i) {
    const int ch = c_begin + i / ipc, sh = i - (i / ipc) * ipc;
    const uint8_t* bs = smem + (i & 1) * kSl + 32768 + wg * 16384;
    const uint32_t xt = base + (i & 1) * kSl;
    if (sh == 0) {  // state <- exp(cum[T-1]) state, then + the hand-on
      const float tot = *tot_s;
      dec *= tot;
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] *= tot;
    }
    mbar_wait(smem_u32(&bars[i & 1]), (i >> 1) & 1);
#pragma unroll
    for (int at = 0; at < 2; ++at) {
      repro::FragA fa[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int s0 = 8 * (4 * at + kk) + 2 * t4;  // k slots t4, t4 + 4
        const float w0 = tail[64 * sh + s0], w1 = tail[64 * sh + s0 + 1];
        auto bv = [&](int s, int n) {  // B[s][n] of the tile, atom n / 32
          return *reinterpret_cast<const float*>(bs + (n >> 5) * 8192 +
                                                 swz(s, n & 31));
        };
        fa[kk] = repro::FragA(bv(s0, n0) * w0, bv(s0, n0 + 8) * w0,
                              bv(s0 + 1, n0) * w1, bv(s0 + 1, n0 + 8) * w1);
      }
      float uf[32];
      atom_product<64>(uf, fa, xt + 8192 * at, xt + 16384 + 8192 * at);
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] += uf[e];
    }
    if (sh == ipc - 1) {  // the state entering chunk ch + 1
      float* out = A.states + ((long long)bh * A.nc + ch + 1) * A.P * A.N;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int n = 64 * wg + n0 + 8 * ((e >> 1) & 1);
        const int p = 64 * pt + 8 * (e >> 2) + 2 * t4 + (e & 1);
        out[(long long)p * A.N + n] = st[e];
      }
      if (blockIdx.x == 0 && tid == 0)
        A.totals[(long long)bh * A.nc + ch + 1] = dec;
    }
    if (i + 1 < n_items) {
      repro::cp_async_wait<0>();
      __syncthreads();
      finish(i + 1);
      if (i + 2 < n_items) issue(i + 2);
      fence_proxy_async();
      __syncthreads();
    }
  }
}

// Per (b h, state entry): slot c = r R of each run r >= 1 holds the partial
// state run r - 1 hands on and totals[c] that run's decay; in run order,
// E <- totals[c] E + states[c], states[c] <- E, the true state entering
// chunk c.  4 bytes a run a thread each way.
__global__ void __launch_bounds__(256)
ssd_wide_carry_kernel(float* __restrict__ states,
                      const float* __restrict__ totals, int nc, int R,
                      long long PN) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.y;
  float* st = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  float E = 0.f;
  for (int c = R; c <= nc - 1; c += R) {
    E = fmaf(tot[c], E, st[(long long)c * PN]);
    st[(long long)c * PN] = E;
  }
}

// ------------------------------------------------------------ output

// The A fragments of C for the k-steps of N atom na (a TMA tile of 128
// rows at cs + na kAtom): rows r0 = 64 wg + 16 warp + g and r0 + 8,
// columns 8 kk + t4 and + 4 of the atom.
__device__ __forceinline__ void c_frags(repro::FragA (&fa)[4],
                                        const uint8_t* cs, int na, int r0,
                                        int t4) {
  const uint8_t* base = cs + na * kAtom;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = 8 * kk + t4;
    auto at = [&](int r, int c) {
      return *reinterpret_cast<const float*>(base + swz(r, c));
    };
    fa[kk] = repro::FragA(at(r0, col), at(r0 + 8, col), at(r0, col + 4),
                          at(r0 + 8, col + 4));
  }
}

// ys += G x over x item XI (s in 64 XI .. + 63): A = G's accumulators,
// columns 2 t4, 2 t4 + 1 of each 8-column block as k slots t4, t4 + 4
template <int XI>
__device__ __forceinline__ void gx_item(float (&ys)[32], const float (&G)[64],
                                        uint32_t xt) {
#pragma unroll
  for (int at = 0; at < 2; ++at) {
    repro::FragA fa[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int jb = 8 * XI + 4 * at + kk;
      fa[kk] = repro::FragA(G[4 * jb], G[4 * jb + 2], G[4 * jb + 1],
                            G[4 * jb + 3]);
    }
    float yf[32];
    atom_product<64>(yf, fa, xt + 8192 * at, xt + 16384 + 8192 * at);
#pragma unroll
    for (int e = 0; e < 32; ++e) ys[e] += yf[e];
  }
}

// The output launch's item list for one chunk: B over each N atom (NB),
// then per P tile the state over each pair of N atoms (NSI, none in chunk
// 0) and x over s in 64-row items (NX).
struct Items {
  int NB, NSI, per_pt, n;
  __device__ __forceinline__ bool is_x(int i) const {
    return i >= NB && (i - NB) % per_pt >= NSI;
  }
};

// Warpgroup wg's part of item i: rows 64 wg .. + 63 of the chunk,
// so G's columns NG = 64 (wg + 1).
template <int NG>
__device__ __forceinline__ void output_item(
    const Args& A, const Items& it, int i, uint32_t slot, const uint8_t* cs,
    const double* cum, float (&G)[64], float (&ys)[32], long long row0,
    int hh) {
  constexpr int wg = NG / 64 - 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + g;
  if (i < it.NB) {  // G += C B^T over N atom i
    repro::FragA fa[4];
    c_frags(fa, cs, i, r0, t4);
    float gf[NG / 2];
    atom_product<NG>(gf, fa, slot, slot + kAtom);
#pragma unroll
    for (int e = 0; e < NG / 2; ++e) G[e] += gf[e];
    if (i == it.NB - 1) {  // mask, then decay: G[t][s] for s <= t
#pragma unroll
      for (int e = 0; e < NG / 2; ++e) {
        const int t = r0 + 8 * ((e >> 1) & 1);
        const int s = 8 * (e >> 2) + 2 * t4 + (e & 1);
        G[e] = s <= t ? G[e] * expf((float)(cum[t] - cum[s])) : 0.f;
      }
    }
    return;
  }
  const int j = i - it.NB, pt = j / it.per_pt, k = j - pt * it.per_pt;
  if (k < it.NSI) {  // ys += C state^T over N atoms 2k, 2k + 1
#pragma unroll
    for (int a2 = 0; a2 < 2; ++a2) {
      repro::FragA fa[4];
      c_frags(fa, cs, 2 * k + a2, r0, t4);
      float yf[32];
      atom_product<64>(yf, fa, slot + 8192 * a2, slot + 16384 + 8192 * a2);
#pragma unroll
      for (int e = 0; e < 32; ++e) ys[e] += yf[e];
    }
    return;
  }
  const int xi = k - it.NSI;
  if (xi == 0) {  // ys = exp(cum[t]) C state^T, then + G x
    const float d0 = expf((float)cum[r0]), d1 = expf((float)cum[r0 + 8]);
#pragma unroll
    for (int e = 0; e < 32; ++e) ys[e] *= (e & 2) ? d1 : d0;
    gx_item<0>(ys, G, slot);
  } else if constexpr (NG == 128) {
    gx_item<1>(ys, G, slot);
  }
  if (xi == it.per_pt - it.NSI - 1) {  // the P tile's rows of y
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int t = r0 + 8 * ((e >> 1) & 1);
      const int p = 64 * pt + 8 * (e >> 2) + 2 * t4 + (e & 1);
      if (t < A.T) A.y[((row0 + t) * A.H + hh) * A.P + p] = ys[e];
      ys[e] = 0.f;
    }
  }
}

// One CTA a (chunk, b h), two warpgroups: rows 0-63 and 64-127 (idle where
// T <= 64).  tb, tc: b, c as [B nc, T, H, N] with boxes of 32 x 1 x
// min(64, T) x 1; ts: states as [B H nc, P, N] with boxes of 32 x 64 x 1.  C (every N
// atom) lands once; B and state tiles land raw in a three-slot ring, TMA
// issued two items ahead, and are split in place by all threads between
// two barriers; x is read into registers one item ahead.
__global__ void __launch_bounds__(256, 1)
ssd_wide_output_kernel(const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tc,
                       const __grid_constant__ CUtensorMap ts,
                       const Args A) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kRing + 1];  // ring slots, then C
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  uint8_t* cs = smem + kRing * kSlot;  // [N / 32][128 rows][32], swizzled
  double* cum = reinterpret_cast<double*>(cs + (A.N / 32) * kAtom);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;
  const int ch = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / A.H, hh = bh - bi * A.H;
  const long long row0 = (long long)bi * A.S + (long long)ch * A.T;
  const int zc = bi * A.nc + ch;  // this chunk in tb and tc
  Items it;
  it.NB = A.N / 32;
  it.NSI = ch > 0 ? A.N / 64 : 0;
  it.per_pt = it.NSI + (A.T + 63) / 64;
  it.n = it.NB + (A.P / 64) * it.per_pt;
  const bool active = 64 * wg < A.T;
  // the entering state: slot ch, plus totals[ch] x the run's first slot
  // unless ch starts a run or lies in the first one
  const bool add = ch > A.R && ch % A.R != 0;
  const int zs = bh * A.nc + ch, zr = bh * A.nc + (ch / A.R) * A.R;
  const float dec = add ? A.totals[zs] : 0.f;
  // a B or C atom: one box of T rows, or two of 64 (rows past T zero)
  const int nbox = A.T > 64 ? 2 : 1;
  const uint32_t tile_bytes = (uint32_t)nbox * min(64, A.T) * 128;

  auto issue = [&](int i) {  // thread 0: item i's copies into its slot
    const uint32_t slot = base + (i % kRing) * kSlot;
    const uint32_t bar = smem_u32(&bars[i % kRing]);
    if (i < it.NB) {
      mbar_expect_tx(bar, tile_bytes);
      for (int r = 0; r < nbox; ++r)
        tma_load_4d(slot + 8192 * r, &tb, bar, 32 * i, hh, 64 * r, zc);
    } else if (!it.is_x(i)) {
      const int j = i - it.NB, pt = j / it.per_pt, k = j - pt * it.per_pt;
      mbar_expect_tx(bar, add ? 4 * 8192 : 2 * 8192);
      for (int a2 = 0; a2 < 2; ++a2) {
        tma_load_3d(slot + 8192 * a2, &ts, bar, 64 * k + 32 * a2, 64 * pt,
                    zs);
        if (add)
          tma_load_3d(slot + 16384 + 8192 * a2, &ts, bar, 64 * k + 32 * a2,
                      64 * pt, zr);
      }
    } else {
      mbar_arrive(bar);  // x comes through registers
    }
  };
  float4 xr[4];
  auto fetch_x = [&](int i) {  // every thread: x item i into registers
    const int j = i - it.NB, pt = j / it.per_pt;
    const int xi = j - pt * it.per_pt - it.NSI;
    load_x<8>(xr, A.x + ((row0 + 64 * xi) * A.H + hh) * A.P + 64 * pt,
              (long long)A.H * A.P, A.T - 64 * xi);
  };
  auto finish = [&](int i) {  // every thread: item i landed -> hi, lo
    uint8_t* slot = smem + (i % kRing) * kSlot;
    mbar_wait(smem_u32(&bars[i % kRing]), (i / kRing) & 1);
    if (i < it.NB) split_tile(slot, kAtom, false, 0.f);
    else if (!it.is_x(i)) split_tile(slot, 16384, add, dec);
    else store_xt<8>(slot, xr);
  };

  if (tid == 0) {
    for (int k = 0; k <= kRing; ++k) mbar_init(smem_u32(&bars[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t cbar = smem_u32(&bars[kRing]);
    mbar_expect_tx(cbar, it.NB * tile_bytes);
    for (int na = 0; na < it.NB; ++na)
      for (int r = 0; r < nbox; ++r)
        tma_load_4d(smem_u32(cs) + na * kAtom + 8192 * r, &tc, cbar, 32 * na,
                    hh, 64 * r, zc);
    for (int i = 0; i < kRing && i < it.n; ++i) issue(i);
  }
  if (it.n > 1 && it.is_x(1)) fetch_x(1);
  if (warp == 0) {  // cum = cumsum(a) over the chunk, fp64
    float av[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = lane * 4 + k;
      av[k] = t < A.T ? A.a[(row0 + t) * A.H + hh] : 0.f;
    }
    double v[4], last;
    chunk_cumsum(v, last, av, lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) cum[lane * 4 + k] = v[k];
  }
  mbar_wait(smem_u32(&bars[kRing]), 0);
  finish(0);
  fence_proxy_async();
  __syncthreads();

  float G[64], ys[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) G[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) ys[e] = 0.f;
  for (int i = 0; i < it.n; ++i) {
    const uint32_t slot = base + (i % kRing) * kSlot;
    if (active) {
      if (wg == 0)
        output_item<64>(A, it, i, slot, cs, cum, G, ys, row0, hh);
      else
        output_item<128>(A, it, i, slot, cs, cum, G, ys, row0, hh);
    }
    __syncthreads();  // slot i % kRing is free
    if (tid == 0 && i + kRing < it.n) issue(i + kRing);
    if (i + 1 < it.n) {
      finish(i + 1);
      if (i + 2 < it.n && it.is_x(i + 2)) fetch_x(i + 2);
      fence_proxy_async();
      __syncthreads();
    }
  }
}

// The device's SM count, and whether this process has raised the kernels'
// shared-memory limits on it (once: each launch then skips the calls).
struct DeviceState {
  int sms = 0;
  bool attributes = false;
};

DeviceState& device_state() {
  static DeviceState states[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  DeviceState& d = states[dev];
  if (d.sms == 0 &&
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    d.sms = 132;
  return d;
}

cudaError_t set_attributes() {
  DeviceState& d = device_state();
  if (d.attributes) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_wide_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      1024 + kRing * kSlot + (kMaxWidth / 32) * kAtom + 8 * kT);
  const void* states[4] = {(const void*)ssd_wide_state_kernel<1>,
                           (const void*)ssd_wide_state_kernel<2>,
                           (const void*)ssd_wide_state_kernel<3>,
                           (const void*)ssd_wide_state_kernel<4>};
  for (int w = 1; w <= 4 && e == cudaSuccess; ++w)
    e = cudaFuncSetAttribute(states[w - 1],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             st_smem(w));
  d.attributes = e == cudaSuccess;
  return e;
}

// Run length: the state launch's P tiles x B H x runs fill the SMs once
// (one run where the tiles alone do), so the carry walks few runs.
int run_length(int BH, int P, int N, int nc) {
  if (nc < 2) return 1;
  const int sms = device_state().sms;
  const long long per_run = (long long)(P / 64) * BH;
  long long nr = sms / per_run;
  nr = nr < 1 ? 1 : (nr > nc - 1 ? nc - 1 : nr);
  return (int)((nc - 1 + nr - 1) / nr);
}

template <int W>
cudaError_t launch_states(const CUtensorMap& tb, const Args& args, int nr,
                          int BH, cudaStream_t s) {
  ssd_wide_state_kernel<W><<<dim3((unsigned)(args.P / 64), (unsigned)nr,
                                  (unsigned)BH),
                             128 * W, st_smem(W), s>>>(tb, args);
  return cudaGetLastError();
}

}  // namespace

// The widest head the kernel takes (P and N alike).
extern "C" int ssd_scan_wide_max_width() { return kMaxWidth; }

// The run length R the state launch walks at these sizes (nc = S / T).
extern "C" int ssd_scan_wide_run_length(int B, int H, int P, int N, int nc) {
  return run_length(B * H, P, N, nc);
}

// x, y [B, S, H, P]; a [B, S, H]; b, c [B, S, H, N]; fp32, contiguous,
// 16-byte aligned, P and N multiples of 64.  states [B, H, S / T, P, N]
// and totals [B, H, S / T] are fp32 scratch.  T is the chunk (S % T ==
// 0); T <= 128, P, N <= 256, B H <= 65535.  launch_ms: null, or three
// floats for the device ms of the state, carry and output launches (CUDA
// events around each, 0 for one that does not run; the call then waits
// for the stream).
extern "C" int ssd_scan_wide_launch(const void* x, const void* a,
                                    const void* b, const void* c, void* y,
                                    void* states, void* totals, int B, int S,
                                    int H, int P, int N, int T, void* stream,
                                    float* launch_ms) {
  if (B < 0 || S < 0 || H < 1 || P < 64 || P > kMaxWidth || P % 64 ||
      N < 64 || N > kMaxWidth || N % 64 || T < 1 || T > kT || S % T != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)states) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nc = S / T, BH = B * H;
  const int R = run_length(BH, P, N, nc);
  const Args args{(const float*)x, (const float*)a, (const float*)b,
                  (const float*)c, (float*)y,       (float*)states,
                  (float*)totals,  S, H, P, N, T, nc, R};

  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tb, tc, ts;
  {  // b, c as [B nc][T][H][N]; states as [B H nc][P][N]
    const cuuint64_t d4[4] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B * nc};
    const cuuint64_t s4[3] = {(cuuint64_t)N * 4, (cuuint64_t)H * N * 4,
                              (cuuint64_t)T * H * N * 4};
    const cuuint32_t b4[4] = {32, 1, (cuuint32_t)(T < 64 ? T : 64), 1};
    const cuuint64_t d3[3] = {(cuuint64_t)N, (cuuint64_t)P,
                              (cuuint64_t)BH * nc};
    const cuuint64_t s3[2] = {(cuuint64_t)N * 4, (cuuint64_t)P * N * 4};
    const cuuint32_t b3[3] = {32, 64, 1};
    constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!repro::tensor_map(&tb, enc, f32, b, 4, d4, s4, b4) ||
        !repro::tensor_map(&tc, enc, f32, c, 4, d4, s4, b4) ||
        !repro::tensor_map(&ts, enc, f32, states, 3, d3, s3, b3))
      return (int)cudaErrorInvalidValue;
  }
  const int out_bytes = 1024 + kRing * kSlot + (N / 32) * kAtom + 8 * kT;
  cudaError_t e = set_attributes();
  cudaEvent_t ev[4] = {};
  for (int k = 0; launch_ms != nullptr && k < 4 && e == cudaSuccess; ++k)
    e = cudaEventCreate(&ev[k]);
  auto mark = [&](int k) {  // the stream's position before launch k
    if (launch_ms != nullptr && e == cudaSuccess)
      e = cudaEventRecord(ev[k], s);
  };
  // one chunk: the state is zero throughout, no state or carry launch
  const int nr = nc > 1 ? (nc - 1 + R - 1) / R : 0;
  mark(0);
  if (nr > 0 && e == cudaSuccess) {
    switch (N / 64) {
      case 1: e = launch_states<1>(tb, args, nr, BH, s); break;
      case 2: e = launch_states<2>(tb, args, nr, BH, s); break;
      case 3: e = launch_states<3>(tb, args, nr, BH, s); break;
      default: e = launch_states<4>(tb, args, nr, BH, s); break;
    }
  }
  mark(1);
  if (nr > 1 && e == cudaSuccess) {
    const long long PN = (long long)P * N;
    ssd_wide_carry_kernel<<<dim3((unsigned)((PN + 255) / 256),
                                 (unsigned)BH),
                            256, 0, s>>>((float*)states, (const float*)totals,
                                         nc, R, PN);
    e = cudaGetLastError();
  }
  mark(2);
  if (e == cudaSuccess) {
    ssd_wide_output_kernel<<<dim3((unsigned)nc, (unsigned)BH), 256,
                             out_bytes, s>>>(tb, tc, ts, args);
    e = cudaGetLastError();
  }
  mark(3);
  if (launch_ms != nullptr) {
    if (e == cudaSuccess) e = cudaEventSynchronize(ev[3]);
    for (int k = 0; k < 3 && e == cudaSuccess; ++k)
      e = cudaEventElapsedTime(&launch_ms[k], ev[k], ev[k + 1]);
    for (cudaEvent_t v : ev)
      if (v != nullptr) cudaEventDestroy(v);
  }
  return (int)e;
}
