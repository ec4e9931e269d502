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
//   s_j   = (q_i * scale) . k_j       fp32; scale = 1/sqrt(D) by default
//   s_j   = -1e30 where causal and j > i (the reference's constant)
//   m, l, acc: the online softmax over key tiles, all fp32
//   out_i = acc / max(l, 1e-30), cast to q's dtype (fp32 or bf16).
//
// Any S >= 1: keys past S in the last tile are masked like causal ones and
// query rows past S are computed from zeros and never stored.  Key 0 is
// live for every row and sits in the first tile, so m is a real score
// after that tile and every masked key weighs exp(-1e30 - m) = 0, as in
// the reference.
//
// Bound on the H100: operations.  4 D flops a (query, key) pair, and
// S (S + 1) / 2 pairs a head when causal (S^2 otherwise); this kernel runs
// them on the fp32 pipes outside the tensor cores (67 TFLOP/s), so at
// B = 2, H = 24, S = 4096, D = 128 the bound is 3.08 ms in fp32, while the
// bytes (q, k, v read once, out written once: 268 MB) take 0.08 ms.  For
// bf16 the bound is the tensor cores' 989 TFLOP/s, which this kernel does
// not use yet (no mma / wgmma, no TMA).
//
// Design: one CTA of 8 warps per (b * h, 64-row query tile), heaviest
// causal tiles first.  The Q tile is scaled and staged once in shared
// memory as fp32; K and V stream through shared memory in tiles of 32
// keys (fp32, K rows padded to D + 4 floats so that lane j reads row j as
// float4s without bank conflicts).  Each warp owns 8 query rows:
//   scores  lane j holds key j of the tile and takes its dot product with
//           the 8 rows (the rows' float4s are shared-memory broadcasts), so
//           one K load feeds 8 rows and no shuffle reduction is needed;
//   softmax the row max over the tile by 5 xor shuffles; each lane keeps
//           its own share of l, summed across the warp once at the end;
//   P @ V   each lane owns ceil(D / 32) output columns (d = lane + 32 i,
//           d < D) of the 8 rows in registers; the tile's p values go
//           through a small per-warp shared buffer and are read back as
//           broadcasts.
// D is a template parameter: 16 and 32 (the CPU-test configs' head
// widths), 64, 112 (zamba2-7b's shared block), 128 and 256 (gemma-7b).
// At D = 112 a lane owns columns lane, lane + 32, lane + 64 and, in the
// low half-warp only, lane + 96; K rows (D + 4 = 116 floats) are still
// read as float4s without bank conflicts.
// Causal key tiles past a CTA's last row are never loaded, and a warp
// skips a tile that lies wholly above its 8 rows (its p would all be 0),
// as the Pallas grid bound skips masked KV blocks.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // query rows a CTA
constexpr int kBlockN = 32;                     // keys a tile, one a lane
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype
}

// Shared memory of one CTA, in floats: Q tile, K tile (padded rows),
// V tile, and each warp's [kBlockN][kRowsPerWarp] p buffer.
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;
  static constexpr int q = kBlockM * D;
  static constexpr int k = kBlockN * kStride;
  static constexpr int v = kBlockN * D;
  static constexpr int p = kWarps * kBlockN * kRowsPerWarp;
  static constexpr size_t bytes = sizeof(float) * (size_t)(q + k + v + p);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KH, int S, int causal, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int KS = Smem<D>::kStride;
  constexpr int NI = (D + 31) / 32;  // output columns a lane owns
  // column lane + 32 i exists: always, unless D is not a multiple of 32
  auto col_ok = [](int i) {
    return D % 32 == 0 || (int)(threadIdx.x & 31) + 32 * i < D;
  };
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Smem<D>::q;
  float* vs = ks + Smem<D>::k;
  float* ps = vs + Smem<D>::v;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // longest first
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const long long q_base = (long long)bh * S * D;
  const long long kv_base = ((long long)b * KH + kh) * S * D;

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D;
    const int row = m0 + r;
    qs[idx] = row < S
        ? to_float(q[q_base + (long long)row * D + (idx - r * D)]) * scale
        : 0.f;
  }

  const int row0 = m0 + warp * kRowsPerWarp;  // this warp's first row
  const float* qw = qs + warp * kRowsPerWarp * D;
  float* pw = ps + warp * kBlockN * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NI];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = causal ? min(S, m0 + kBlockM) : S;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    __syncthreads();  // the last tile is consumed (and Q is staged)
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int key = n0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < S) {
        const long long g = kv_base + (long long)key * D + d;
        kx = to_float(k[g]);
        vx = to_float(v[g]);
      }
      ks[j * KS + d] = kx;
      vs[idx] = vx;
    }
    __syncthreads();
    if (row0 >= S) continue;  // rows past S: nothing to store
    if (causal && row0 + kRowsPerWarp - 1 < n0) continue;  // all masked

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(ks + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qw + r * D)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int key = n0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool live = key < S && (!causal || key <= row0 + r);
      const float sr = live ? s[r] : kNeg;
      float mx = sr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sr - m_new);
      l[r] = l[r] * alpha + p;  // this lane's share of the row sum
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      pw[lane * kRowsPerWarp + r] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBlockN; ++j) {
      float vj[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        vj[i] = col_ok(i) ? vs[j * D + lane + 32 * i] : 0.f;
      const float4* p4 = reinterpret_cast<const float4*>(pw + j * kRowsPerWarp);
      const float4 pa = p4[0];
      const float4 pb = p4[1];
      const float pr[kRowsPerWarp] = {pa.x, pa.y, pa.z, pa.w,
                                      pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pr[r], vj[i], acc[r][i]);
      }
    }
    __syncwarp();  // pw is read before the next tile writes it
  }

  if (row0 >= S) return;  // no barrier follows
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float lt = l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lt += __shfl_xor_sync(kFull, lt, o);
    const int row = row0 + r;
    if (row < S) {
      const float denom = fmaxf(lt, 1e-30f);
      T* o = out + q_base + (long long)row * D;
#pragma unroll
      for (int i = 0; i < NI; ++i)
        if (col_ok(i)) store(o + lane + 32 * i, acc[r][i] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int S, int causal, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockM - 1) / kBlockM));
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KH, S, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KH, int S, int D, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    case 112:
      return launch<T, 112>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, KH, S, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KH, int S, int D, int causal,
                                      float scale, int dtype, void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7FFFFFFFLL || (S + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, H, KH, S, D, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, H, KH, S, D, causal,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}
