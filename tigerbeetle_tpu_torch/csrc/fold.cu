// K7: the chained fold of dense reply codes (the dual-commit digest).
//
// Replaces tigerbeetle_tpu/models/ledger.py fold_reply_codes (:365-379) and
// its three fused forms in tigerbeetle_tpu/models/dual_ledger.py
// (_fold_group_fn, _fold_group_ring_fn, _fold_ring_fn, :88-169; the plain
// jit at :498 and :536): over k slots of n_pad lanes,
//
//   batch_h[j] = sum over lanes l < n[j] of mix(zext(code) * FP_MUL + l + 1)
//   c = active[j] ? mix(c ^ (batch_h[j] + n[j])) : c      for j in order
//
// and, for the ring forms, ring[idx[j]] = c after slot j.
//
// Bound on an H100: bytes, k * n * 4 code bytes read once (0.16 us for 16 x
// 8190 at 3.35 TB/s); far below one launch's latency, which bounds it in
// practice.
//
// Design: one launch of FOLD_BLOCKS blocks, whatever k. The grid's warps
// are dealt out to the slots (warp g sums slot g % k, lanes g / k * 32 +
// lane in steps of 32 times the slot's warp count), so any n_pad and any k
// <= FOLD_K_MAX keep every block busy; a thread issues all its code loads
// (4 at most for 16 x 8192) before it mixes any. Each warp reduces its sum
// with shuffles, each block its warps' sums per slot in shared memory, and
// one thread a slot adds the block's sum into the slot's kept scratch word
// with atomicAdd. The block that finishes last (a counter in the scratch)
// takes the slot sums with atomicExch, which leaves the words zeroed for the
// next call, and one thread chains the k slots in order, writes the chain
// value into the ring slot by slot (a later slot with the same index wins)
// and updates chk in place. The sums wrap mod 2^64, so any order gives the
// same bits. The slot counts, flags and ring indices travel by value in the
// launch. (A 16-block cluster that adds the blocks' sums through
// distributed shared memory took 1.3 us more on the card for 16 x 8190: its
// two cluster barriers cost more than the atomics, PERF.md.)
#include <cuda_runtime.h>

#include "fp.cuh"

#define FOLD_K_MAX 16
#define FOLD_BLOCKS 256
#define FOLD_THREADS 128
#define FOLD_WARPS (FOLD_THREADS / 32)
#define FOLD_UNROLL 4  // code loads a thread issues before it mixes any
#define FOLD_BAD_ARGUMENT (-1)

// Kept between calls (per device and stream): a sum a slot, the count of
// blocks done. Zero before a call, left zero by its last block.
struct FoldScratch {
  ull slot[FOLD_K_MAX];
  unsigned int done;
};

struct FoldArgs {
  const uint32_t* flat;
  ull* chk;
  ull* ring;
  FoldScratch* sc;
  int n_pad, k;
  int n[FOLD_K_MAX];
  int idx[FOLD_K_MAX];
  unsigned active;  // bit j: slot j advances the chain
};

__global__ void __launch_bounds__(FOLD_THREADS) fold_slots(FoldArgs a) {
  __shared__ ull s_warp[FOLD_WARPS];
  __shared__ ull s_slot[FOLD_K_MAX];
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k;
  const int g = (int)blockIdx.x * FOLD_WARPS + warp;
  const int j = g % k;
  const int n = a.n[j];
  const int step = (FOLD_BLOCKS * FOLD_WARPS - j + k - 1) / k * 32;  // the slot's warps x 32
  const uint32_t* codes = a.flat + (size_t)j * a.n_pad;
  ull m = 0;
  for (int l0 = g / k * 32 + lane; l0 < n; l0 += FOLD_UNROLL * step) {
    uint32_t v[FOLD_UNROLL];
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; u++) {
      const int l = l0 + u * step;
      v[u] = l < n ? __ldg(codes + l) : 0u;
    }
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; u++) {
      const int l = l0 + u * step;
      if (l < n) m += fp_mix((ull)v[u] * FP_MUL + (ull)l + 1ull);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m += __shfl_down_sync(0xFFFFFFFFu, m, off);
  if (lane == 0) s_warp[warp] = m;
  __syncthreads();
  if ((int)threadIdx.x < k) {
    ull s = 0;
    for (int w = 0; w < FOLD_WARPS; w++) {
      if (((int)blockIdx.x * FOLD_WARPS + w) % k == (int)threadIdx.x) s += s_warp[w];
    }
    if (s != 0) atomicAdd(&a.sc->slot[threadIdx.x], s);
    __threadfence();  // the block's sums land before its count of done
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&a.sc->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // the last block: every other block's sums are in
  if ((int)threadIdx.x < k) s_slot[threadIdx.x] = atomicExch(&a.sc->slot[threadIdx.x], 0ull);
  __syncthreads();
  if (threadIdx.x != 0) return;
  atomicExch(&a.sc->done, 0u);
  ull c = *a.chk;
  for (int s = 0; s < k; s++) {
    if (a.active >> s & 1u) c = fp_mix(c ^ (s_slot[s] + (ull)a.n[s]));
    if (a.ring != nullptr) a.ring[a.idx[s]] = c;
  }
  *a.chk = c;
}

extern "C" size_t tb_fold_scratch_bytes() { return sizeof(FoldScratch); }

// flat: flat_len u32 codes, slot j at [j * n_pad, (j + 1) * n_pad); slots:
// host 64-bit ints, k slot counts (0 <= n <= n_pad), then the active flags
// as a bit mask, then (with a ring) k ring indices (0 <= idx < ring_len);
// chk: one u64, read and written; ring: ring_len u64 or null; scratch:
// tb_fold_scratch_bytes() bytes, zero before the first call on a stream and
// left zero by each call. Returns FOLD_BAD_ARGUMENT, launching nothing, on a
// slot count k outside 1..16, a count or an index out of its range, or
// codes past flat_len.
extern "C" int tb_fold(const uint32_t* flat, long long flat_len, int n_pad, int k,
                       const long long* slots, ull* chk, ull* ring, int ring_len, void* scratch,
                       cudaStream_t stream) {
  if (k < 1 || k > FOLD_K_MAX || n_pad < 0 || n_pad > (1 << 30) ||
      (long long)k * n_pad > flat_len)
    return FOLD_BAD_ARGUMENT;
  FoldArgs a{};
  a.flat = flat;
  a.chk = chk;
  a.ring = ring;
  a.sc = static_cast<FoldScratch*>(scratch);
  a.n_pad = n_pad;
  a.k = k;
  a.active = (unsigned)slots[k];
  for (int j = 0; j < k; j++) {
    if (slots[j] < 0 || slots[j] > n_pad) return FOLD_BAD_ARGUMENT;
    a.n[j] = (int)slots[j];
    if (ring != nullptr) {
      const long long idx = slots[k + 1 + j];
      if (idx < 0 || idx >= ring_len) return FOLD_BAD_ARGUMENT;
      a.idx[j] = (int)idx;
    }
  }
  fold_slots<<<FOLD_BLOCKS, FOLD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
