// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016) for a single-pass stable
// compaction, and the per-call state it keeps between launches. Used by K8
// (filter_scan.cu) and K10's split (spill_split.cu, which clears its state
// every call and so always passes epoch 1).
//
// Tiles are taken in order from a tile counter, so every tile's
// predecessors were taken by blocks that are running or done: a tile may
// wait on them. Each tile publishes one 64-bit status word: first its own
// aggregate (flag AGG), then, once its exclusive prefix is known, its
// inclusive prefix (flag INC). A successor sums aggregates backwards until
// it meets an inclusive prefix, 32 predecessors at a time (one warp).
//
// A status word packs flag (bits 63-62), epoch (61-32) and value (31-0).
// The caller passes a new epoch each call on the same state buffer, so a
// word left by an earlier call never reads as ready and nothing is cleared
// between calls. The tile counter and the exit counter come back to zero at
// the end of every call: the last block out clears them.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#define LB_AGG 1u
#define LB_INC 2u
#define LB_EPOCH_MASK 0x3FFFFFFFu
#define LB_FULL 0xFFFFFFFFu

// The state buffer: the two counters, then one status word per tile.
struct LookbackState {
  unsigned* ctr;  // [0]: tiles taken; [1]: blocks that have left
  unsigned long long* status;
};

static inline size_t lookback_bytes(long long tiles) { return 256 + (size_t)tiles * 8; }

static inline LookbackState lookback_carve(char* buf) {
  LookbackState s;
  s.ctr = reinterpret_cast<unsigned*>(buf);
  s.status = reinterpret_cast<unsigned long long*>(buf + 256);
  return s;
}

__device__ __forceinline__ unsigned long long lb_pack(unsigned flag, unsigned epoch,
                                                      unsigned value) {
  return ((unsigned long long)flag << 62) | ((unsigned long long)(epoch & LB_EPOCH_MASK) << 32) |
         value;
}

__device__ __forceinline__ void lb_publish(unsigned long long* status, long long tile,
                                           unsigned flag, unsigned epoch, unsigned value) {
  *reinterpret_cast<volatile unsigned long long*>(status + tile) = lb_pack(flag, epoch, value);
}

// The flag of a status word of this epoch, 0 for another epoch's.
__device__ __forceinline__ unsigned lb_flag(unsigned long long s, unsigned epoch) {
  return (unsigned)((s >> 32) & LB_EPOCH_MASK) == (epoch & LB_EPOCH_MASK) ? (unsigned)(s >> 62)
                                                                          : 0u;
}

__device__ __forceinline__ unsigned long long lb_load(const unsigned long long* status,
                                                      long long tile) {
  return *reinterpret_cast<const volatile unsigned long long*>(status + tile);
}

// The exclusive prefix of `tile` (> 0), by one whole warp; every lane gets
// it. Lane l reads predecessor tile - 1 - l - 32 k in round k.
__device__ __forceinline__ unsigned lb_exclusive(const unsigned long long* status, long long tile,
                                                 unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0u;
  for (long long top = tile - 1;; top -= 32) {
    const long long p = top - lane;
    unsigned long long s;
    unsigned flag;
    do {  // a tile before 0 counts as an inclusive prefix of 0
      s = p >= 0 ? lb_load(status, p) : lb_pack(LB_INC, epoch, 0u);
      flag = lb_flag(s, epoch);
    } while (!__all_sync(LB_FULL, flag != 0u));
    const unsigned inc = __ballot_sync(LB_FULL, flag == LB_INC);
    unsigned v = (unsigned)s;
    if (inc) {  // the nearest inclusive prefix ends the walk
      const int first = __ffs(inc) - 1;
      return excl + __reduce_add_sync(LB_FULL, lane <= first ? v : 0u);
    }
    excl += __reduce_add_sync(LB_FULL, v);
  }
}

// Block-wide: the next tile for this block (every thread gets it). `slot`
// is one int of shared memory.
__device__ __forceinline__ long long lb_take_tile(LookbackState st, unsigned* slot) {
  __syncthreads();  // everyone has read the previous tile's number
  if (threadIdx.x == 0) *slot = atomicAdd(st.ctr, 1u);
  __syncthreads();
  return (long long)*slot;
}

// Block-wide, once a block has taken its last tile: the last block out
// clears both counters for the next call.
__device__ __forceinline__ void lb_leave(LookbackState st) {
  if (threadIdx.x != 0) return;
  __threadfence();  // this block's last take precedes its leave
  if (atomicAdd(st.ctr + 1, 1u) == gridDim.x - 1) {
    __threadfence();
    st.ctr[0] = 0u;
    st.ctr[1] = 0u;
  }
}
