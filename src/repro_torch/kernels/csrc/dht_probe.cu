// dht_lookup and dht_insert: the open-addressed dual-lane hash table.
//
// Replace the Pallas kernels repro/kernels/dht_probe.py:dht_lookup (body
// `_lookup_kernel`) and :dht_insert (body `_insert_kernel`), whose jnp
// oracles are repro/core/dht.py:lookup_jnp and :insert_jnp.
//
// dht_lookup: one thread per query walks the linear-probe chain from
// hash & (cap-1) in global memory (the table stays L2-resident at moderate
// capacity).  Bound: memory latency of the dependent probe loads; the bytes
// are ~9 per probe step plus 13 per query.
//
// dht_insert: bulk-synchronous claim rounds over the whole key batch.  The
// race is global, so keys cannot be tiled inside a block: which key wins a
// slot decides where later keys land.  Each round is two launches, so the
// launch boundary is the grid-wide barrier:
//   claim    every pending key records, in per-key scratch, whether its
//            slot was used and held its own key at round start, and bids
//            atomicMax(owner[slot], key index) if the slot was empty;
//   resolve  from the recorded flags only (the table is never re-read):
//            the highest bidder writes the slot and resets owner to -1; a
//            key that met itself is done (dedupe); a key that met a
//            different key advances one slot; a race loser stays and
//            retries the same slot next round.
// A key that has probed cap slots is exhausted and overflows alone.  The
// resolve pass counts keys still pending into a device counter, read back
// every kCheckEvery rounds; extra rounds are no-ops.  The rounds run over a
// worklist of the valid keys (built by the init pass), so a batch that is
// mostly invalid rows (the seed-index build: ~2% valid) costs rounds over
// its valid keys only.  Bound: latency of ~2 launches per round; each round
// touches ~14 bytes per valid key.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCheckEvery = 4;

__global__ void lookup_kernel(const uint32_t* __restrict__ slot_hi,
                              const uint32_t* __restrict__ slot_lo,
                              const uint8_t* __restrict__ used,
                              const int32_t* __restrict__ max_probe,
                              uint32_t cap_mask,
                              const uint32_t* __restrict__ qhi,
                              const uint32_t* __restrict__ qlo,
                              const uint8_t* __restrict__ qvalid, long long n,
                              int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t result = -1;
  if (qvalid[i]) {
    result = repro::probe(slot_hi, slot_lo, used, cap_mask, *max_probe + 1,
                          qhi[i], qlo[i]);
  }
  out[i] = result;
}

__global__ void insert_init_kernel(const uint32_t* __restrict__ khi,
                                   const uint32_t* __restrict__ klo,
                                   const uint8_t* __restrict__ kvalid,
                                   long long n, uint32_t cap_mask,
                                   uint8_t* __restrict__ done,
                                   int32_t* __restrict__ attempt,
                                   int32_t* __restrict__ probes,
                                   int32_t* __restrict__ work,
                                   int32_t* __restrict__ n_work) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n && kvalid[i];
  if (i < n) {
    done[i] = !valid;
    attempt[i] = (int32_t)(repro::kmer_hash(khi[i], klo[i]) & cap_mask);
    probes[i] = 0;
  }
  // append the valid keys to the worklist, one atomic per warp; the order
  // of the list does not matter, a key bids with its own batch index
  const unsigned lane = threadIdx.x & 31;
  const unsigned votes = __ballot_sync(0xffffffffu, valid);
  int32_t base = 0;
  if (lane == 0 && votes) base = atomicAdd(n_work, __popc(votes));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (valid) work[base + __popc(votes & ((1u << lane) - 1))] = (int32_t)i;
}

// flags bits: 1 = pending this round, 2 = slot used, 4 = slot holds the key
__global__ void insert_claim_kernel(const uint32_t* __restrict__ khi,
                                    const uint32_t* __restrict__ klo,
                                    long long n, long long cap,
                                    const uint32_t* __restrict__ slot_hi,
                                    const uint32_t* __restrict__ slot_lo,
                                    const uint8_t* __restrict__ used,
                                    const uint8_t* __restrict__ done,
                                    const int32_t* __restrict__ attempt,
                                    const int32_t* __restrict__ probes,
                                    uint8_t* __restrict__ flags,
                                    int32_t* __restrict__ owner,
                                    const int32_t* __restrict__ work) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int32_t i = work[t];
  if (done[i] || probes[i] >= cap) {
    flags[i] = 0;
    return;
  }
  const int32_t a = attempt[i];
  const bool cur_used = used[a];
  const bool cur_match = cur_used && slot_hi[a] == khi[i] && slot_lo[a] == klo[i];
  flags[i] = 1 | (cur_used ? 2 : 0) | (cur_match ? 4 : 0);
  if (!cur_used) atomicMax(owner + a, i);
}

__global__ void insert_resolve_kernel(const uint32_t* __restrict__ khi,
                                      const uint32_t* __restrict__ klo,
                                      long long n, long long cap,
                                      uint32_t cap_mask,
                                      uint32_t* __restrict__ slot_hi,
                                      uint32_t* __restrict__ slot_lo,
                                      uint8_t* __restrict__ used,
                                      uint8_t* __restrict__ done,
                                      int32_t* __restrict__ attempt,
                                      int32_t* __restrict__ probes,
                                      const uint8_t* __restrict__ flags,
                                      int32_t* __restrict__ owner,
                                      int32_t* __restrict__ pending,
                                      const int32_t* __restrict__ work) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t i = t < n ? work[t] : 0;
  bool still = false;
  if (t < n && (flags[i] & 1)) {
    const uint8_t f = flags[i];
    const bool cur_used = f & 2;
    const bool cur_match = f & 4;
    const int32_t a = attempt[i];
    bool fin = cur_match;  // dedupe against the key already in the slot
    // Only the winner resets owner, after reading it; a loser reads either
    // the winner's index or -1, never its own.
    if (!cur_used && owner[a] == i) {
      slot_hi[a] = khi[i];
      slot_lo[a] = klo[i];
      used[a] = 1;
      owner[a] = -1;
      fin = true;
    }
    if (fin) {
      done[i] = 1;
    } else if (cur_used) {  // occupied by a different key: advance
      attempt[i] = (int32_t)((uint32_t)(a + 1) & cap_mask);
      const int32_t p = probes[i] + 1;
      probes[i] = p;
      still = p < cap;
    } else {  // lost the race: retry the same slot
      still = true;
    }
  }
  const unsigned votes = __ballot_sync(0xffffffffu, still);
  if ((threadIdx.x & 31) == 0 && votes) atomicAdd(pending, __popc(votes));
}

__global__ void insert_finish_kernel(const uint8_t* __restrict__ kvalid,
                                     long long n,
                                     const uint8_t* __restrict__ done,
                                     const int32_t* __restrict__ attempt,
                                     const int32_t* __restrict__ probes,
                                     int32_t* __restrict__ slots,
                                     int32_t* __restrict__ max_probe) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t p = 0;
  if (i < n) {
    slots[i] = (kvalid[i] && done[i]) ? attempt[i] : -1;
    p = probes[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    p = max(p, __shfl_xor_sync(0xffffffffu, p, off));
  if ((threadIdx.x & 31) == 0 && p > 0) atomicMax(max_probe, p);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dht_lookup_launch(const void* slot_hi, const void* slot_lo,
                                 const void* used, const void* max_probe,
                                 long long cap, const void* qhi,
                                 const void* qlo, const void* qvalid,
                                 long long n, void* out, void* stream) {
  if (n == 0) return 0;
  lookup_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
      (const uint8_t*)used, (const int32_t*)max_probe, (uint32_t)(cap - 1),
      (const uint32_t*)qhi, (const uint32_t*)qlo, (const uint8_t*)qvalid, n,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// Inserts keys into (slot_hi, slot_lo, used) in place.  Scratch, allocated
// by the caller: done/flags [n] uint8, attempt/probes/work [n] int32, owner
// [cap] int32 filled with -1, counters [2] int32 (zeroed).  max_probe [1]
// holds the old bound on entry and max(old, max probes) on return.  The
// rounds run over the worklist of valid keys only (claim/resolve index it),
// while done/attempt/probes stay indexed by batch position.
extern "C" int dht_insert_launch(void* slot_hi, void* slot_lo, void* used,
                                 void* max_probe, long long cap,
                                 const void* khi, const void* klo,
                                 const void* kvalid, long long n, void* slots,
                                 void* done, void* flags, void* attempt,
                                 void* probes, void* owner, void* work,
                                 void* counters, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t cap_mask = (uint32_t)(cap - 1);
  int32_t* pending = (int32_t*)counters;
  int32_t* n_work = (int32_t*)counters + 1;
  insert_init_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const uint32_t*)khi, (const uint32_t*)klo, (const uint8_t*)kvalid, n,
      cap_mask, (uint8_t*)done, (int32_t*)attempt, (int32_t*)probes,
      (int32_t*)work, n_work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int32_t m = 0;
  err = cudaMemcpyAsync(&m, n_work, sizeof(int32_t), cudaMemcpyDeviceToHost,
                        s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = blocks_for(m);
  // Each key finishes within 2 rounds per slot it probes, and probes at
  // most cap slots.
  const long long max_rounds = 2 * cap + 2 * kCheckEvery;
  for (long long round = 0; m > 0; round += kCheckEvery) {
    if (round > max_rounds) return -1;
    for (int j = 0; j < kCheckEvery; ++j) {
      err = cudaMemsetAsync(pending, 0, sizeof(int32_t), s);
      if (err != cudaSuccess) return (int)err;
      insert_claim_kernel<<<blocks, kThreads, 0, s>>>(
          (const uint32_t*)khi, (const uint32_t*)klo, m, cap,
          (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
          (const uint8_t*)used, (const uint8_t*)done,
          (const int32_t*)attempt, (const int32_t*)probes, (uint8_t*)flags,
          (int32_t*)owner, (const int32_t*)work);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      insert_resolve_kernel<<<blocks, kThreads, 0, s>>>(
          (const uint32_t*)khi, (const uint32_t*)klo, m, cap, cap_mask,
          (uint32_t*)slot_hi, (uint32_t*)slot_lo, (uint8_t*)used,
          (uint8_t*)done, (int32_t*)attempt, (int32_t*)probes,
          (const uint8_t*)flags, (int32_t*)owner, pending,
          (const int32_t*)work);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    int32_t left = 0;
    err = cudaMemcpyAsync(&left, pending, sizeof(int32_t),
                          cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return (int)err;
    if (left == 0) break;
  }
  insert_finish_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const uint8_t*)kvalid, n, (const uint8_t*)done,
      (const int32_t*)attempt, (const int32_t*)probes, (int32_t*)slots,
      (int32_t*)max_probe);
  return (int)cudaGetLastError();
}
