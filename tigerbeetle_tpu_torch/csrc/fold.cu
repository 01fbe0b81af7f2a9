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
// 8190 at 3.35 TB/s); far below one launch's latency, so the two launches
// bound it in practice.
//
// Design: pass 1 is a grid of (lane blocks, k slots), one thread per lane,
// a warp-shuffle and shared-memory reduction, and one atomicAdd per block
// into the slot's u64 scratch word. The sum wraps mod 2^64, so any order
// gives the same bits. Pass 2 is one thread: it chains the k slots in
// order, writes the chain value into the ring slot by slot (a later slot
// with the same index wins, deterministically), updates chk in place and
// zeroes the scratch words for the next call on the stream. The slot
// counts, flags and ring indices travel by value in the launch.
#include <cuda_runtime.h>

#include "fp.cuh"

#define FOLD_K_MAX 16
#define FOLD_THREADS 256

struct FoldSlots {
  int n[FOLD_K_MAX];
  int idx[FOLD_K_MAX];
  unsigned active;  // bit j: slot j advances the chain
};

__global__ void fold_lanes(const uint32_t* __restrict__ flat, int n_pad, FoldSlots s,
                           ull* batch_h) {
  int j = blockIdx.y;
  int n = s.n[j];
  int first = blockIdx.x * FOLD_THREADS;
  if (first >= n) return;  // the whole block lies past the slot's lanes
  int lane = first + threadIdx.x;
  ull m = 0;
  if (lane < n) {
    ull code = flat[(size_t)j * n_pad + lane];
    m = fp_mix(code * FP_MUL + (ull)lane + 1ull);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m += __shfl_down_sync(0xFFFFFFFFu, m, off);
  __shared__ ull s_sum[FOLD_THREADS / 32];
  int w_lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (w_lane == 0) s_sum[warp] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  ull total = 0;
#pragma unroll
  for (int w = 0; w < FOLD_THREADS / 32; w++) total += s_sum[w];
  atomicAdd(batch_h + j, total);
}

__global__ void fold_chain(ull* chk, ull* ring, int k, FoldSlots s, ull* batch_h) {
  ull c = *chk;
  for (int j = 0; j < k; j++) {
    if (s.active >> j & 1u) c = fp_mix(c ^ (batch_h[j] + (ull)s.n[j]));
    if (ring != nullptr) ring[s.idx[j]] = c;
    batch_h[j] = 0;
  }
  *chk = c;
}

// flat: k slots of n_pad u32 codes (more words may follow); ns, active,
// idxs: host arrays of k slot counts (0 <= n <= n_pad), flags and ring
// indices (0 <= idx < ring_len; ignored without a ring); chk: one u64, read
// and written; ring: ring_len u64 or null; scratch: FOLD_K_MAX zeroed u64,
// left zeroed.
extern "C" int tb_fold(const uint32_t* flat, int n_pad, int k, const int* ns,
                       const uint8_t* active, const int* idxs, ull* chk, ull* ring,
                       int ring_len, ull* scratch, cudaStream_t stream) {
  if (k < 1 || k > FOLD_K_MAX || n_pad < 0) return (int)cudaErrorInvalidValue;
  FoldSlots s{};
  for (int j = 0; j < k; j++) {
    if (ns[j] < 0 || ns[j] > n_pad) return (int)cudaErrorInvalidValue;
    s.n[j] = ns[j];
    if (active[j]) s.active |= 1u << j;
    if (ring != nullptr) {
      if (idxs[j] < 0 || idxs[j] >= ring_len) return (int)cudaErrorInvalidValue;
      s.idx[j] = idxs[j];
    }
  }
  int blocks = (n_pad + FOLD_THREADS - 1) / FOLD_THREADS;
  if (blocks > 0) {
    fold_lanes<<<dim3(blocks, k), FOLD_THREADS, 0, stream>>>(flat, n_pad, s, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fold_chain<<<1, 1, 0, stream>>>(chk, ring, k, s, scratch);
  return (int)cudaGetLastError();
}
